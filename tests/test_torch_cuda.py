"""The port's hand-written kernels on an NVIDIA GPU: each wrapper against its
plain PyTorch version, the wrappers' refusals, the launch counters, and the
paged engine on the card against the same engine on the CPU.

Marked ``cuda``; every test skips on a host without CUDA.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's kernel bars: float32 1e-5 (paged 2e-5),
bf16 2e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mask as mk
from repro_torch.core.config import get_config, smoke_config
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.paged import paged_attn, paged_attn_ref
from repro_torch.kernels.ref import NEG_INF, chunk_attn_ref
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve.engine import Engine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


FLASH = [
    # (B, Tq, Tk, Hq, Hkv, D, dtype, mask)
    (1, 256, 1024, 8, 8, 128, torch.bfloat16, mk.causal(rel_offset=768)),
    (2, 100, 300, 4, 2, 64, torch.float32, mk.causal(rel_offset=200)),
    (1, 128, 128, 4, 1, 32, torch.float32, mk.sliding_window(33)),
    (1, 192, 192, 2, 2, 64, torch.float32, mk.prefix_lm(50)),
    (1, 128, 128, 4, 4, 32, torch.float32, mk.document(boundaries=(0, 9, 70))),
    (1, 64, 96, 4, 4, 128, torch.bfloat16, mk.full()),
]


@pytest.mark.parametrize("case", FLASH, ids=[c[-1].kind + str(i)
                                             for i, c in enumerate(FLASH)])
def test_flash_fwd_kernel_matches_plain(dev, case):
    B, Tq, Tk, Hq, Hkv, D, dtype, mask = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (B, Tq, Hq, D), dtype, dev)
    k = _randn(gen, (B, Tk, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Tk, Hkv, D), dtype, dev)
    n0 = build.LAUNCHES["flash_fwd"]
    o, lse = flash_fwd(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == n0 + 1
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    ok = lse_r > NEG_INF / 2
    torch.testing.assert_close(lse[ok], lse_r[ok], atol=1e-4, rtol=1e-4)
    o_d, _ = flash_fwd(q, k, v, mask=mask, prune=False)
    assert float((o_d.float() - o.float()).abs().max()) <= 1e-6


PAGED = [
    # (B, Tq, Hq, Hkv, D, bs, lengths, window, dtype)
    (4, 1, 32, 32, 128, 16, [1, 700, 513, 1032], 0, torch.bfloat16),
    (4, 4, 8, 2, 64, 8, [3, 9, 40, 77], 0, torch.float32),
    (3, 2, 4, 1, 32, 64, [1, 65, 200], 30, torch.float32),
]


@pytest.mark.parametrize("case", PAGED)
def test_paged_kernel_matches_plain(dev, case):
    B, Tq, Hq, Hkv, D, bs, lengths, window, dtype = case
    gen = torch.Generator(device=dev).manual_seed(1)
    nb = -(-max(lengths) // bs) + 1
    N = B * nb + 4
    q = _randn(gen, (B, Tq, Hq, D), dtype, dev)
    kp = _randn(gen, (N, bs, Hkv, D), dtype, dev)
    vp = _randn(gen, (N, bs, Hkv, D), dtype, dev)
    bt = (torch.randperm(N - 1, generator=gen, device=dev)[:B * nb] + 1
          ).reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = mk.sliding_window(window) if window else mk.causal()
    n0 = build.LAUNCHES["paged_decode"]
    o = paged_attn(q, kp, vp, bt, lens, mask=mask)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode"] == n0 + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        o.float(), paged_attn_ref(q, kp, vp, bt, lens, mask=mask).float(),
        atol=tol, rtol=tol)


def test_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros((1, 64, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd(q, q, q, mask=mk.causal())
    h = torch.zeros((1, 64, 2, 32), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        flash_fwd(h, h, h, mask=mk.causal())
    qd = torch.zeros((1, 1, 2, 32), device=dev)
    pool = torch.zeros((4, 4, 2, 32), device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="block sizes"):
        paged_attn(qd, pool, pool, bt, ln)


def test_engine_on_card_matches_cpu(dev):
    """Smoke llama-gqa (float32, D = 32): the engine on the card, through
    both kernels, emits the same greedy streams as on the CPU."""
    cfg = smoke_config(get_config("llama-gqa"))
    cpu = DecoderLM(cfg, device="cpu")
    params = cpu.init(0)
    gpu = DecoderLM(cfg, device=dev)
    params_d = {k: (v.to(dev) if torch.is_tensor(v) else
                    [{g: {n: t.to(dev) for n, t in d.items()}
                      for g, d in lp.items()} for lp in v])
                for k, v in params.items()}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 40))
    kw = dict(max_batch=4, block_size=16, n_blocks=32,
              prefill_chunk_tokens=16)
    build.reset_launches()
    eng = Engine(gpu, params_d, **kw)
    out_d = eng.generate({"tokens": prompts}, 8)
    st = eng.stats()
    assert st["prefill_seconds"] > 0 and st["decode_seconds"] > 0
    assert build.LAUNCHES["flash_fwd"] > 0
    assert build.LAUNCHES["paged_decode"] > 0
    out_c = Engine(cpu, params, **kw).generate({"tokens": prompts}, 8)
    np.testing.assert_array_equal(out_d, out_c)
