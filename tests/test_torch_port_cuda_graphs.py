"""The sampler's and the fine-tune's CUDA graphs on the card (CUDA only;
every test skips without a CUDA device): at full width with random weights
(utils/params.random_params), a forced 344-frame request on the serving
default (int8) with ddpm and dpm2:cs2, graphed (infer/graphs.py) against
graphs=False: bit-equal mels, exact launch counts (the captures' launches
taken back, the replays' added), one capture a step kind and the rest
replays; a load_state_dict between two requests recaptures; the
fine-tune's graphed losses and weights bit-equal to the eager loop's on a
small decoder. Run on a CUDA machine beside the other card tests:

    python -m pytest --noconftest -q tests/test_torch_port_cuda_graphs.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.config import DecoderConfig, MainConfig
from unitspeech_tpu_torch.infer import graphs as tgraphs
from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
from unitspeech_tpu_torch.models.diffusion import UnitSpeech
from unitspeech_tpu_torch.ops import kernel_wrappers
from unitspeech_tpu_torch.train import finetune as tft
from unitspeech_tpu_torch.utils.params import random_params

FRAMES, STEPS = 344, 6


@pytest.fixture(scope="module")
def synth():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = Synthesizer(TTSModels.from_checkpoint(random_params(MainConfig(), 0), device="cuda",
                                              use_int8_deep=True))
    yield s
    del s
    torch.cuda.empty_cache()


def _request(synth, spec, seed):
    """A forced 344-frame request's mel and the launches it made."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    _, _, mel = synth(list(range(1, 41)), torch.Generator("cuda").manual_seed(seed),
                      forced_total_frames=FRAMES, diffusion_steps=STEPS,
                      text_gradient_scale=1.0, spk_gradient_scale=1.0, sampler=spec)
    torch.cuda.synchronize()
    return mel.float().cpu(), {k: w.launches for k, w in wrappers.items() if w.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ddpm", "dpm2:cs2"])
def test_graphed_request_equals_eager(synth, spec):
    eager = dataclasses.replace(synth, graphs=False)
    want, want_launches = _request(eager, spec, 0)
    got, launches = _request(synth, spec, 0)
    cache = tgraphs.graphs_for(synth.models.decoder, synth.models.spk_emb)
    kinds = 2 if spec.endswith(":cs2") else 1
    captures = cache.captures
    assert torch.equal(got, want) and launches == want_launches
    again, launches2 = _request(synth, spec, 0)
    assert torch.equal(again, want) and launches2 == want_launches
    assert cache.captures == captures
    other, _ = _request(synth, spec, 1)
    assert not torch.equal(other, want)
    assert kinds <= captures


@pytest.mark.cuda
def test_load_state_dict_recaptures(synth):
    dec = synth.models.decoder
    cache = tgraphs.graphs_for(dec, synth.models.spk_emb)
    want, _ = _request(synth, "ddpm", 2)
    n = cache.captures
    dec.load_state_dict(dec.state_dict())
    got, _ = _request(synth, "ddpm", 2)
    assert cache.captures == n + 1 and torch.equal(got, want)


@pytest.mark.cuda
def test_finetune_graphed_equals_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = DecoderConfig(n_feats=16, dim=64, dim_mults=[1, 2], groups=8, spk_emb_dim=8)
    rng = np.random.default_rng(0)
    with torch.device("cuda"):
        base = UnitSpeech.from_config(cfg).state_dict()
    for v in base.values():
        v.copy_(torch.from_numpy(0.1 * rng.standard_normal(v.shape).astype(np.float32)))
    t_y, t_x = 48, 12
    cond_x = torch.randn(1, t_x, 16, device="cuda")
    y = torch.randn(1, t_y, 16, device="cuda").tanh()
    y_len = torch.tensor([40], device="cuda")
    attn = torch.zeros(1, t_x, t_y, device="cuda")
    for x in range(t_x):
        attn[0, x, 4 * x:4 * x + 4] = 1.0
    spk = torch.nn.functional.normalize(torch.randn(1, 8, device="cuda"), dim=-1)
    runs = [tft.finetune_decoder(cfg, base, cond_x, y, y_len, attn, spk, segment_size=32,
                                 n_iters=8, learning_rate=1e-3, graphs=g,
                                 generator=torch.Generator("cuda").manual_seed(3))
            for g in (False, True)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in base)
