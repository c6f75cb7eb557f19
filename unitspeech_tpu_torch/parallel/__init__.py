"""Several processes, one card each (counterpart of unitspeech_tpu/parallel):
the process-group launch (launch.py) and the device mesh with every
collective the port makes (mesh.py). Data-parallel STEP1 / STEP2
(train/steps.py, train/loop.py), speaker-per-rank fine-tuning
(train/finetune.py), data- and sequence-sharded sampling and batched
synthesis (models/diffusion.py, models/unet.py, infer/tts.py) and
distributed transcription (tools/distributed_transcribe.py) run on them."""

from unitspeech_tpu_torch.parallel.launch import (  # noqa: F401
    Group,
    local_device,
    maybe_initialize_distributed,
    resolve_topology,
    run_group,
)
from unitspeech_tpu_torch.parallel.mesh import (  # noqa: F401
    SEQ_UNIT,
    DataShard,
    FrameSlice,
    SeqShard,
    make_mesh,
    replicate_tree,
    sample_shard,
    shard_batch,
    train_shard,
)
