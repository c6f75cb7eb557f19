"""The serving slice's shapes of the port's kernels on the card (CUDA only;
every test skips without a CUDA device): K4 at the widths whose weight
tiles stream through the x ring (C > 512, csrc/rezero_attention.cu
`kv_smem` / `out_slots`), at the C = 1024 sites of the long buckets. Run on
a CUDA machine beside tests/test_torch_port_cuda.py:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py \\
        tests/test_torch_port_cuda_serving.py
"""

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.ops import fused_attention

BF16_REL = 2.0 ** -6  # tests/test_torch_port_cuda.py's bf16 bound on max |kernel - plain|


@pytest.fixture
def dev():
    """The card, with TF32 off for the plain version's f32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

# (B, N, C, packed at load): the F = 10 stage of the 880-frame bucket (the
# first whose T * F passes the attention gate) and of the 1256-frame bucket
# at B = 3 (one request's guidance rows) and B = 24 (a batch of 8), a ragged
# N, and C = 768
WIDE_CASES = [(3, 1100, 1024, True), (3, 1570, 1024, False), (24, 1100, 1024, True),
              (3, 1030, 1024, True), (3, 1337, 768, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,pack", WIDE_CASES)
def test_rezero_attention_streamed_weights(dev, b, n, c, pack):
    rng = np.random.default_rng(n + c + b)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    x = r(b, n, c).to(torch.bfloat16)
    w_qkv, w_out = r(c, 384, scale=c ** -0.5), r(128, c, scale=128 ** -0.5)
    b_out, g = r(c, scale=0.1), torch.tensor([0.7], device=dev)
    lens = torch.tensor([n if i % 3 != 1 else n * 7 // 9 for i in range(b)], dtype=torch.int32,
                        device=dev)
    packed = fused_attention.pack_attention_weights(w_qkv, w_out) if pack else None
    before = fused_attention.fused_rezero_attention.launches
    got = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens, packed=packed)
    assert fused_attention.fused_rezero_attention.launches == before + 1
    want = fused_attention.rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens, 4, 32)
    assert not got[1, lens[1]:].any()  # rows past the length come out zero
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_REL * max(1.0, want.float().abs().max().item()), err
    again = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens,
                                                   packed=packed)
    assert torch.equal(got, again)  # fixed order: the same bits every call
