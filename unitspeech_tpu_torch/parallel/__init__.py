"""Several processes, one card each (counterpart of unitspeech_tpu/parallel):
the process-group launch (launch.py), the device mesh with every
collective the port makes (mesh.py) and tensor parallelism over its model
axis (tp.py). Data-parallel STEP1 / STEP2
(train/steps.py, train/loop.py), speaker-per-rank fine-tuning
(train/finetune.py), data- and sequence-sharded sampling and batched
synthesis (models/diffusion.py, models/unet.py, infer/tts.py), the
model-sharded sampler, Synthesizer and STEP1 step, and distributed
transcription (tools/distributed_transcribe.py) run on them."""

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
    ModelShard,
    SeqShard,
    make_mesh,
    replicate_tree,
    sample_shard,
    shard_batch,
    train_shard,
)
from unitspeech_tpu_torch.parallel.tp import (  # noqa: F401
    SHARDED_LEAF_NAMES,
    gather_params_tp,
    shard_params_tp,
    tp_spec,
    tp_spec_tree,
)
