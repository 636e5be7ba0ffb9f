"""The port's hand-written kernels on an NVIDIA GPU: each wrapper against its
plain PyTorch version, the wrappers' refusals, the launch counters, the
paged engine and the training step on the card against the same on the
CPU.

Marked ``cuda``; every test skips on a host without CUDA.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's kernel bars: forward float32 1e-5 (paged
2e-5), bf16 2e-2; backward float32 2e-4, bf16 5e-2; training losses 2e-3.
bf16 outputs of kernel A (its tensor-core route) are also held element by
element to 3e-2 of each element's size, as ``chip_smoke.py`` holds them;
bf16 outputs of kernels C and D (their tensor-core route, which rounds p
and ds to bf16) are also held row by row to 2e-2 of each row's norm
(``row_rel_err``), the bar ``chip_smoke.py`` holds them to.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mask as mk
from repro_torch.core.config import (ShapeSpec, TrainConfig, get_config,
                                     smoke_config)
from repro_torch.core.tree import tree_map
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
from repro_torch.kernels.paged import paged_attn, paged_attn_ref
from repro_torch.kernels.ref import (NEG_INF, chunk_attn_bwd_ref,
                                     chunk_attn_ref, row_rel_err)
from repro_torch.models.transformer import DecoderLM, trainable
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_step

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
    # (B, Tq, Tk, Hq, Hkv, D, mask, segments), each in float32 and bf16:
    # head dims 32/64/128, GQA, ragged Tq/Tk, q and kv offsets, every mask
    # kind, rows with nothing to attend
    (1, 256, 1024, 8, 8, 128, mk.causal(rel_offset=768), False),
    (2, 100, 300, 4, 2, 64, mk.causal(rel_offset=200), False),
    (1, 128, 128, 4, 1, 32, mk.sliding_window(33), False),
    (1, 192, 192, 2, 2, 64, mk.prefix_lm(50), False),
    (1, 128, 128, 4, 4, 32, mk.document(boundaries=(0, 9, 70)), False),
    (2, 128, 256, 4, 2, 32, mk.document(), True),
    (1, 64, 200, 4, 4, 32, mk.MaskSpec(q_offset=10, kv_offset=3), False),
    (1, 128, 128, 2, 2, 128, mk.causal(rel_offset=-64), False),
    (1, 64, 96, 4, 4, 128, mk.full(), False),
    # a speculative draft's catch-up chunk: smollm-360m's 15 heads over 5
    # kv heads of 64, 32 rows against the gathered table
    (1, 32, 1056, 15, 5, 64, mk.causal(rel_offset=1000), False),
    # the Qwen family's serving chunk (Tq 256 at q_offset 768, Tk 1024):
    # qwen3-8b's GQA group 4, qwen2.5-14b's group 5, qwen1.5-32b's 40 heads
    (1, 256, 1024, 32, 8, 128, mk.causal(rel_offset=768), False),
    (1, 256, 1024, 40, 8, 128, mk.causal(rel_offset=768), False),
    (1, 256, 1024, 40, 40, 128, mk.causal(rel_offset=768), False),
]
# bf16: the tensor-core route is held element by element too (3e-2 of each
# output, chip_smoke.py's rel_err); pruned and dense sweeps do the same
# arithmetic on every live tile, and may differ by less than half a bf16
# step at the largest output (2^-9 of it; one step there is at least 2^-8)
PRUNE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -9}


def _rel_err(a, r):
    a, r = a.float(), r.float()
    return float(((a - r).abs() / (r.abs() + 1e-3 * r.abs().max())).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH, ids=[c[-2].kind + str(i)
                                             for i, c in enumerate(FLASH)])
def test_flash_fwd_kernel_matches_plain(dev, case, dtype):
    B, Tq, Tk, Hq, Hkv, D, mask, segs = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (B, Tq, Hq, D), dtype, dev)
    k = _randn(gen, (B, Tk, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Tk, Hkv, D), dtype, dev)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 3, (B, Tk), generator=gen,
                                     device=dev), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    n0 = build.LAUNCHES["flash_fwd"]
    o, lse = flash_fwd(q, k, v, mask=mask, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == n0 + 1
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, **kw)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    ok = lse_r > NEG_INF / 2
    assert bool((lse[~ok] == NEG_INF).all())
    torch.testing.assert_close(lse[ok], lse_r[ok], atol=1e-4, rtol=1e-4)
    if dtype == torch.bfloat16:
        assert _rel_err(o, o_r) <= 3e-2
    o_d, _ = flash_fwd(q, k, v, mask=mask, prune=False, **kw)
    limit = PRUNE_TOL[dtype] * (1.0 if dtype == torch.float32
                                else float(o_r.float().abs().max()))
    assert float((o_d.float() - o.float()).abs().max()) <= limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_fwd_empty_chunk_launches_nothing(dev, dtype):
    q = torch.ones((1, 128, 2, 64), device=dev, dtype=dtype)
    n0 = build.LAUNCHES["flash_fwd"]
    o, lse = flash_fwd(q, q, q, mask=mk.causal(rel_offset=-1000))
    assert build.LAUNCHES["flash_fwd"] == n0
    assert float(o.abs().max()) == 0 and bool((lse == NEG_INF).all())


BWD = [
    # (B, Tq, Tk, Hq, Hkv, D, dtype, mask, segments)
    (1, 512, 512, 8, 8, 128, torch.bfloat16, mk.causal(), False),
    (2, 100, 300, 4, 2, 64, torch.float32, mk.causal(rel_offset=200), False),
    (1, 128, 128, 4, 1, 32, torch.float32, mk.sliding_window(33), False),
    (1, 192, 192, 2, 2, 64, torch.float32, mk.prefix_lm(50), False),
    (1, 128, 128, 4, 4, 32, torch.float32, mk.document(boundaries=(0, 9, 70)),
     False),
    (2, 128, 128, 4, 2, 32, torch.float32, mk.document(), True),
    (1, 128, 128, 2, 2, 32, torch.float32, mk.causal(rel_offset=-64), False),
    (1, 64, 96, 4, 4, 128, torch.bfloat16, mk.full(), False),
    # the bf16 tensor-core route: head dims 32/64/128, GQA, ragged Tq/Tk,
    # rows with nothing to attend, segments, prefix and window edge tiles
    (1, 128, 128, 4, 2, 32, torch.bfloat16, mk.causal(), False),
    (2, 100, 300, 4, 2, 64, torch.bfloat16, mk.causal(rel_offset=200),
     False),
    (1, 128, 128, 2, 2, 128, torch.bfloat16, mk.causal(rel_offset=-64),
     False),
    (2, 128, 256, 4, 2, 64, torch.bfloat16, mk.document(), True),
    (1, 192, 192, 4, 2, 32, torch.bfloat16, mk.prefix_lm(50), False),
    (1, 256, 256, 8, 2, 128, torch.bfloat16, mk.sliding_window(70), False),
]


@pytest.mark.parametrize("case", BWD, ids=[c[-2].kind + str(i)
                                           for i, c in enumerate(BWD)])
def test_flash_bwd_kernels_match_plain(dev, case):
    B, Tq, Tk, Hq, Hkv, D, dtype, mask, segs = case
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, (B, Tq, Hq, D), dtype, dev)
    k = _randn(gen, (B, Tk, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Tk, Hkv, D), dtype, dev)
    do = _randn(gen, (B, Tq, Hq, D), dtype, dev)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 3, (B, Tk), generator=gen,
                                     device=dev), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    o, lse = chunk_attn_ref(q, k, v, mask=mask, **kw)
    n0 = (build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"])
    got = flash_bwd(q, k, v, o, lse, do, mask=mask, **kw)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["flash_bwd_dq"],
            build.LAUNCHES["flash_bwd_dkv"]) == (n0[0] + 1, n0[1] + 1)
    ref = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=mask, **kw)
    dense = flash_bwd(q, k, v, o, lse, do, mask=mask, prune=False, **kw)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}[dtype]
    for a, r, d in zip(got, ref, dense):
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
        assert float((a.float() - d.float()).abs().max()) <= 1e-6
        if dtype == torch.bfloat16:
            assert row_rel_err(a, r) <= 2e-2


PAGED = [
    # (B, Tq, Hq, Hkv, D, bs, lengths, window, dtype)
    (4, 1, 32, 32, 128, 16, [1, 700, 513, 1032], 0, torch.bfloat16),
    (4, 4, 8, 2, 64, 8, [3, 9, 40, 77], 0, torch.float32),
    (3, 2, 4, 1, 32, 64, [1, 65, 200], 30, torch.float32),
    # split edges (L_s = 256 at bf16 D = 128 and bs 16): L_s - 1, L_s,
    # L_s + 1, 2 L_s
    (4, 1, 8, 8, 128, 16, [255, 256, 257, 512], 0, torch.bfloat16),
    # one 32K-token request: 128 splits and the merge
    (1, 1, 8, 8, 128, 16, [32768], 0, torch.bfloat16),
    # windows across a split boundary
    (4, 1, 8, 2, 128, 16, [300, 600, 700, 1000], 100, torch.bfloat16),
    # Tq > 1, GQA: with window 2 the first rows attend only split 0, the
    # last only split 1
    (2, 4, 8, 2, 128, 16, [258, 770], 2, torch.bfloat16),
    (2, 4, 32, 8, 128, 16, [255, 1016], 0, torch.bfloat16),
    # float32 at D 32 with bs 64 (L_s = 512) and D 64, 128
    (4, 1, 4, 4, 32, 64, [511, 512, 513, 1024], 0, torch.float32),
    (2, 3, 4, 2, 64, 8, [256, 700], 40, torch.float32),
    (2, 2, 4, 4, 128, 16, [129, 300], 0, torch.float32),
    # speculative decoding: the verify pass at llama-7b's heads (Tq = depth
    # + 1 = 5), and smollm-360m's draft (g = 3, D 64) at Tq 1 and Tq 5
    # (g·Tq = 15 rows a block)
    (4, 5, 32, 32, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 1, 15, 5, 64, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 5, 15, 5, 64, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    # the Qwen family at the serving step and at verify Tq 5: groups 4, 5
    # (g·Tq = 25 rows: two 16-row groups) and 1 with 40 heads
    (4, 1, 32, 8, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 5, 32, 8, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 1, 40, 8, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 5, 40, 8, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 1, 40, 40, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
    (4, 5, 40, 40, 128, 16, [1016, 716, 529, 80], 0, torch.bfloat16),
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


def test_paged_kernel_is_bitwise_batch_invariant(dev):
    """One request (1000 tokens, 4 splits, GQA, Tq 2) gives bitwise the same
    o alone, in a batch of 4 with a wider table, under a permuted block
    table, and from one launch to the next."""
    gen = torch.Generator(device=dev).manual_seed(5)
    B, Tq, Hq, Hkv, D, bs, nb = 4, 2, 8, 2, 128, 16, 70
    N = B * nb + 4
    q = _randn(gen, (B, Tq, Hq, D), torch.bfloat16, dev)
    kp = _randn(gen, (N, bs, Hkv, D), torch.bfloat16, dev)
    vp = _randn(gen, (N, bs, Hkv, D), torch.bfloat16, dev)
    bt = (torch.randperm(N - 1, generator=gen, device=dev)[:B * nb] + 1
          ).reshape(B, nb).to(torch.int32)
    lens = torch.tensor([80, 1000, 529, 1100], dtype=torch.int32,
                        device=dev)
    mask = mk.sliding_window(900)
    full = paged_attn(q, kp, vp, bt, lens, mask=mask)
    again = paged_attn(q, kp, vp, bt, lens, mask=mask)
    assert torch.equal(full, again)
    alone = paged_attn(q[1:2].contiguous(), kp, vp,
                       bt[1:2, :-(-1000 // bs)].contiguous(), lens[1:2],
                       mask=mask)
    assert torch.equal(alone[0], full[1])
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      torch.randperm(N - 1, generator=gen, device=dev) + 1])
    kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    moved = paged_attn(q, kp2, vp2, perm[bt.long()].to(torch.int32), lens,
                       mask=mask)
    assert torch.equal(moved, full)
    torch.testing.assert_close(
        full.float(), paged_attn_ref(q, kp, vp, bt, lens, mask=mask).float(),
        atol=2e-2, rtol=2e-2)


def test_paged_raises_on_unaligned_pool_rows(dev):
    """The kernel stages pool rows with 16-byte copies: pools whose rows do
    not start on 16-byte boundaries raise instead of falling back."""
    q = torch.zeros((1, 1, 2, 32), device=dev, dtype=torch.bfloat16)
    pool = torch.zeros((4, 16, 2, 33), device=dev, dtype=torch.bfloat16)
    bt = torch.ones((1, 2), dtype=torch.int32, device=dev)
    ln = torch.full((1,), 20, dtype=torch.int32, device=dev)
    n0 = build.LAUNCHES["paged_decode"]
    with pytest.raises(ValueError, match="16-byte"):
        paged_attn(q, pool[..., 1:], pool[..., 1:], bt, ln)
    assert build.LAUNCHES["paged_decode"] == n0


def test_wrappers_raise_instead_of_falling_back(dev):
    q = torch.zeros((1, 64, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd(q, q, q, mask=mk.causal())
    h = torch.zeros((1, 64, 2, 32), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        flash_fwd(h, h, h, mask=mk.causal())
    # kernel A's tensor-core route copies 16-byte rows: an odd row start
    # raises
    odd = torch.zeros((1, 64, 2, 33), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd(odd[..., 1:], odd[..., 1:], odd[..., 1:],
                  mask=mk.causal())
    qd = torch.zeros((1, 1, 2, 32), device=dev)
    pool = torch.zeros((4, 4, 2, 32), device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="block sizes"):
        paged_attn(qd, pool, pool, bt, ln)


def test_flash_bwd_raises_instead_of_falling_back(dev):
    q = torch.zeros((1, 64, 2, 96), device=dev)
    lse = torch.zeros((1, 64, 2), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_bwd(q, q, q, q, lse, q, mask=mk.causal())
    h = torch.zeros((1, 64, 2, 32), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        flash_bwd(h, h, h, h, lse, h, mask=mk.causal())
    f = torch.zeros((1, 64, 2, 32), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        flash_bwd(f, f, f, f, lse, f.to(torch.bfloat16), mask=mk.causal())
    # the tensor-core route copies 16-byte rows: an odd row start raises
    b = torch.zeros((1, 64, 2, 33), device=dev, dtype=torch.bfloat16)
    odd = b[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        flash_bwd(odd, odd, odd, odd, lse, odd, mask=mk.causal())


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


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2.5-14b", "qwen1.5-32b"])
def test_qwen_engine_on_card_matches_cpu(dev, arch):
    """Smoke Qwen configs (float32, D = 32) with their biases and qk-norm
    weights moved off their init: the engine on the card, through both
    kernels, emits the same greedy streams as on the CPU."""
    cfg = smoke_config(get_config(arch))
    cpu = DecoderLM(cfg, device="cpu")
    params = cpu.init(0)
    gen = torch.Generator().manual_seed(1)
    for lp in params["layers"]:
        for n, t in lp["attn"].items():
            if n in ("bq", "bk", "bv"):
                t.copy_(0.5 * torch.randn(t.shape, generator=gen))
            elif n in ("q_norm", "k_norm"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    params_d = {k: (v.to(dev) if torch.is_tensor(v) else
                    [{g: {n: t.to(dev) for n, t in d.items()}
                      for g, d in lp.items()} for lp in v])
                for k, v in params.items()}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 40))
    kw = dict(max_batch=4, block_size=16, n_blocks=32,
              prefill_chunk_tokens=16)
    build.reset_launches()
    out_d = Engine(DecoderLM(cfg, device=dev), params_d, **kw).generate(
        {"tokens": prompts}, 8)
    assert build.LAUNCHES["flash_fwd"] > 0
    assert build.LAUNCHES["paged_decode"] > 0
    out_c = Engine(cpu, params, **kw).generate({"tokens": prompts}, 8)
    np.testing.assert_array_equal(out_d, out_c)


def test_depth0_spec_engine_on_card_equals_vanilla(dev):
    """Smoke llama-7b in bf16 on the card: the depth-0 speculative engine
    (verify at T = 1 through kernel B) emits the vanilla engine's streams,
    greedy and sampled."""
    from repro_torch.serve.speculative import SpecConfig
    cfg = smoke_config(get_config("llama-7b")).replace(dtype="bfloat16")
    model = DecoderLM(cfg, device=dev)
    params = model.init(0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 40))
    kw = dict(max_batch=4, block_size=16, n_blocks=32,
              prefill_chunk_tokens=16)
    outs = []
    for spec in (None, SpecConfig(depth=0, mode="none")):
        for temp in (0.0, 0.8):
            n0 = build.LAUNCHES["paged_decode"]
            eng = Engine(model, params, spec=spec, **kw)
            outs.append(eng.generate({"tokens": prompts}, 8,
                                     temperature=temp))
            assert build.LAUNCHES["paged_decode"] > n0
    np.testing.assert_array_equal(outs[2], outs[0])
    np.testing.assert_array_equal(outs[3], outs[1])


def test_training_steps_on_card_match_cpu(dev):
    """Two steps of the smoke llama-gqa (float32, D = 32) through kernels
    A, C and D on the card give the losses and parameters of the same
    steps on the CPU."""
    cfg = smoke_config(get_config("llama-gqa")).replace(vocab=128)
    tc = TrainConfig(lr=3e-3, warmup_steps=1, total_steps=2)
    shape = ShapeSpec("t", 128, 2, "train")
    init = DecoderLM(cfg, device="cpu").init(0)
    out = {}
    for d in ("cpu", dev):
        model = DecoderLM(cfg, device=d)
        params = trainable(tree_map(lambda t: t.to(d, copy=True), init))
        opt = adamw.init(params)
        step = make_train_step(model, tc)
        ds = SyntheticTokens(cfg, shape, device=d)
        build.reset_launches()
        losses = [step(params, opt, ds.batch(i))["loss"] for i in range(2)]
        out[str(d)] = (losses, params, dict(build.LAUNCHES))
    (l_c, p_c, _), (l_d, p_d, n_d) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(l_d, l_c, atol=2e-3)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert n_d[k] == 2 * cfg.n_layers, (k, n_d)
    torch.testing.assert_close(p_d["layers"][0]["attn"]["wq"].detach().cpu(),
                               p_c["layers"][0]["attn"]["wq"].detach(),
                               atol=1e-4, rtol=1e-3)


def test_head_parallel_pool_equals_one_rank_kernel_bitwise(dev):
    """llama-7b's 32 kv heads over 4 ranks sharing the card (cuda-ipc):
    kernel B on each rank's 8 heads, all-gathered over heads,
    equals one launch over every head bit for bit (B is per head and
    batch-invariant)."""
    import _torch_long_cases as LC
    from repro_torch.launch.world import spawn
    build.build_all()
    res = spawn(LC.head_parallel_world, 4, (4,), device=dev, timeout=300)
    assert res[0][0] is True
    assert all(r[1] == 1 for r in res)
    assert {r[2] for r in res} == {"cuda-ipc"}


# ------------------------------------------------- the MLA latent shape
# absorbed MLA (deepseek-v2-lite-16b): q/k 576 (latent 512 ⊕ rope 64), v
# the first 512 columns of the latent rows, one kv head under 16 query
# heads, scale 1/√192

LATENT_SCALE = 192 ** -0.5


def _latent_chunk(gen, dev, dtype, Tq, Tk, view=True):
    q = _randn(gen, (1, Tq, 16, 576), dtype, dev)
    k = _randn(gen, (1, Tk, 1, 576), dtype, dev)
    v = k[..., :512] if view else _randn(gen, (1, Tk, 1, 512), dtype, dev)
    return q, k, v


LATENT_FLASH = [
    # (Tq, Tk, mask, v a view of k): the serving chunk (Tq 256 at q_offset
    # 768 over 1024 gathered keys); ragged tiles under a window; a v of
    # its own; a first chunk whose early rows see few keys; a document mask
    # with two boundaries inside the chunk; a window under which rows 13 on
    # see no key (whole position tiles and rows inside a live tile: o = 0,
    # lse = NEG_INF); 99 positions, 1584 (position, head) rows, not a
    # multiple of the bf16 route's 64-row tiles
    (256, 1024, mk.causal(rel_offset=768), True),
    (37, 100, mk.sliding_window(40), True),
    (64, 160, mk.causal(rel_offset=96), False),
    (256, 256, mk.causal(), True),
    (192, 960, mk.document(boundaries=(0, 850, 940), rel_offset=768), True),
    (64, 64, mk.MaskSpec(causal=True, window=150, q_offset=200), True),
    (99, 300, mk.causal(rel_offset=201), True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LATENT_FLASH,
                         ids=[f"{c[0]}x{c[1]}{'v' if c[3] else ''}"
                              for c in LATENT_FLASH])
def test_latent_flash_kernel_matches_plain(dev, case, dtype):
    """Kernel A's latent route (q/k 576, v 512) against the plain version:
    o within the forward bar (bf16 also element by element), lse 1e-4;
    one launch, counted as ``flash_fwd_latent``."""
    Tq, Tk, mask, view = case
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = _latent_chunk(gen, dev, dtype, Tq, Tk, view)
    n0 = dict(build.LAUNCHES)
    o, lse = flash_fwd(q, k, v, mask=mask, scale=LATENT_SCALE)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd_latent"] == n0["flash_fwd_latent"] + 1
    assert build.LAUNCHES["flash_fwd"] == n0["flash_fwd"]
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, scale=LATENT_SCALE)
    assert o.shape == (1, Tq, 16, 512)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    dead = lse_r <= NEG_INF / 2
    assert bool((lse[dead] == NEG_INF).all())
    assert bool((o[dead] == 0).all())
    if dtype == torch.bfloat16:
        assert _rel_err(o, o_r) <= 3e-2


def test_latent_flash_bf16_route_is_deterministic(dev):
    """Two launches of the bf16 latent route on the serving chunk give
    bitwise equal o and lse (a fixed sweep order, no atomics)."""
    gen = torch.Generator(device=dev).manual_seed(24)
    q, k, v = _latent_chunk(gen, dev, torch.bfloat16, 256, 1024)
    m = mk.causal(rel_offset=768)
    o1, l1 = flash_fwd(q, k, v, mask=m, scale=LATENT_SCALE)
    o2, l2 = flash_fwd(q, k, v, mask=m, scale=LATENT_SCALE)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", [LATENT_FLASH[0], LATENT_FLASH[5]],
                         ids=["serve", "dead_rows"])
def test_latent_flash_bf16_split_sweep_matches_plain(dev, case, parts,
                                                     monkeypatch):
    """The bf16 latent route with each tile's kv sweep cut into parts and
    merged (rows some part or every part does not see included): within
    the forward bar of the plain version and element by element, dead rows
    (0, NEG_INF), one counted launch; bitwise deterministic."""
    import repro_torch.kernels.flash_attention as fa
    monkeypatch.setattr(fa, "latent_splits", lambda *a: parts)
    Tq, Tk, mask, view = case
    gen = torch.Generator(device=dev).manual_seed(27)
    q, k, v = _latent_chunk(gen, dev, torch.bfloat16, Tq, Tk, view)
    n0 = build.LAUNCHES["flash_fwd_latent"]
    o, lse = flash_fwd(q, k, v, mask=mask, scale=LATENT_SCALE)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd_latent"] == n0 + 1
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, scale=LATENT_SCALE)
    torch.testing.assert_close(o.float(), o_r.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    dead = lse_r <= NEG_INF / 2
    assert bool((lse[dead] == NEG_INF).all()) and bool((o[dead] == 0).all())
    assert _rel_err(o, o_r) <= 3e-2
    o2, lse2 = flash_fwd(q, k, v, mask=mask, scale=LATENT_SCALE)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_latent_flash_bf16_route_serves_strided_q(dev):
    """The bf16 latent route loads q by TMA boxes over (column, head,
    position), so a q whose rows are strided (the 576 columns of a wider
    tensor) is served, bitwise as its contiguous copy."""
    gen = torch.Generator(device=dev).manual_seed(25)
    wide = _randn(gen, (1, 64, 16, 640), torch.bfloat16, dev)
    _, k, v = _latent_chunk(gen, dev, torch.bfloat16, 64, 200)
    q = wide[..., :576]
    m = mk.causal(rel_offset=136)
    o, lse = flash_fwd(q, k, v, mask=m, scale=LATENT_SCALE)
    o_c, lse_c = flash_fwd(q.contiguous(), k, v, mask=m, scale=LATENT_SCALE)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    o_r, _ = chunk_attn_ref(q, k, v, mask=m, scale=LATENT_SCALE)
    assert _rel_err(o, o_r) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [(8, 1), (4, 2), (128, 1)],
                         ids=["g8", "g2x2", "g128"])
def test_latent_flash_kernel_tiles_other_groups(dev, heads, dtype):
    """Groups other than MLA's 16: 8 and 2 (over two kv heads) divide the
    bf16 route's 64-row tiles (8 and 32 positions a tile), 128 is a
    multiple of them (two 64-head tiles a position).  Within the forward
    bar of the plain version, one launch."""
    Hq, Hkv = heads
    gen = torch.Generator(device=dev).manual_seed(26)
    q = _randn(gen, (1, 40, Hq, 576), dtype, dev)
    k = _randn(gen, (1, 100, Hkv, 576), dtype, dev)
    m = mk.causal(rel_offset=60)
    n0 = build.LAUNCHES["flash_fwd_latent"]
    o, lse = flash_fwd(q, k, k[..., :512], mask=m, scale=LATENT_SCALE)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd_latent"] == n0 + 1
    o_r, lse_r = chunk_attn_ref(q, k, k[..., :512], mask=m,
                                scale=LATENT_SCALE)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    if dtype == torch.bfloat16:
        assert _rel_err(o, o_r) <= 3e-2


def test_latent_flash_bf16_refuses_other_groups(dev):
    """A bf16 latent call whose group neither divides 64 nor is a multiple
    of it raises before a launch (no fallback to the CUDA-core route);
    float32 takes it."""
    q = torch.zeros((1, 8, 48, 576), device=dev)
    k = torch.zeros((1, 8, 1, 576), device=dev)
    n0 = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="GQA group"):
        flash_fwd(q.bfloat16(), k.bfloat16(), k.bfloat16()[..., :512],
                  mask=mk.causal())
    assert dict(build.LAUNCHES) == n0
    flash_fwd(q, k, k[..., :512], mask=mk.causal())
    assert build.LAUNCHES["flash_fwd_latent"] == n0["flash_fwd_latent"] + 1


LATENT_PAGED = [
    # (B, Tq, lengths, window, v a view of k): the serving step and verify
    # Tq 5 at phase 4's lengths; a window across splits; a v pool of its
    # own; a request with one token
    (4, 1, [1016, 716, 529, 80], 0, True),
    (4, 5, [1016, 716, 529, 80], 0, True),
    (3, 2, [31, 33, 300], 40, True),
    (2, 5, [64, 97], 0, False),
    (2, 1, [1, 17], 0, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", LATENT_PAGED,
                         ids=[f"B{c[0]}T{c[1]}{'v' if c[4] else ''}"
                              for c in LATENT_PAGED])
def test_latent_paged_kernel_matches_plain(dev, case, dtype):
    """Kernel B over a latent pool (N, 16, 1, 576) with 16 query heads, v
    its 512-column view (or a pool of its own): within the paged bar of
    the plain version, one launch."""
    B, Tq, lengths, window, view = case
    gen = torch.Generator(device=dev).manual_seed(22)
    bs = 16
    nb = -(-max(lengths) // bs) + 1
    N = B * nb + 4
    q = _randn(gen, (B, Tq, 16, 576), dtype, dev)
    kp = _randn(gen, (N, bs, 1, 576), dtype, dev)
    vp = kp[..., :512] if view else _randn(gen, (N, bs, 1, 512), dtype, dev)
    bt = (torch.randperm(N - 1, generator=gen, device=dev)[:B * nb] + 1
          ).reshape(B, nb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = mk.sliding_window(window) if window else mk.causal()
    n0 = build.LAUNCHES["paged_decode"]
    o = paged_attn(q, kp, vp, bt, lens, mask=mask, scale=LATENT_SCALE)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_decode"] == n0 + 1
    assert o.shape == (B, Tq, 16, 512)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        o.float(), paged_attn_ref(q, kp, vp, bt, lens, mask=mask,
                                  scale=LATENT_SCALE).float(),
        atol=tol, rtol=tol)


def test_latent_paged_kernel_is_bitwise_batch_invariant(dev):
    """At the latent shape (bf16, Tq 1): a 1000-token request gives bitwise
    the same o alone, in a batch of 4 with a wider table, under a permuted
    block table, and from one launch to the next."""
    gen = torch.Generator(device=dev).manual_seed(23)
    B, bs, nb = 4, 16, 70
    N = B * nb + 4
    q = _randn(gen, (B, 1, 16, 576), torch.bfloat16, dev)
    kp = _randn(gen, (N, bs, 1, 576), torch.bfloat16, dev)
    bt = (torch.randperm(N - 1, generator=gen, device=dev)[:B * nb] + 1
          ).reshape(B, nb).to(torch.int32)
    lens = torch.tensor([80, 1000, 529, 1100], dtype=torch.int32,
                        device=dev)

    def run(q, kp, bt, lens):
        return paged_attn(q, kp, kp[..., :512], bt, lens,
                          scale=LATENT_SCALE)
    full = run(q, kp, bt, lens)
    assert torch.equal(full, run(q, kp, bt, lens))
    alone = run(q[1:2].contiguous(), kp,
                bt[1:2, :-(-1000 // bs)].contiguous(), lens[1:2])
    assert torch.equal(alone[0], full[1])
    perm = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      torch.randperm(N - 1, generator=gen, device=dev) + 1])
    kp2 = torch.empty_like(kp)
    kp2[perm] = kp
    assert torch.equal(run(q, kp2, perm[bt.long()].to(torch.int32), lens),
                       full)


def test_latent_kernels_raise_on_other_head_dim_pairs(dev):
    """A q/k and v pair the latent routes do not serve raises before a
    launch."""
    q = torch.zeros((1, 32, 16, 576), device=dev)
    k = torch.zeros((1, 32, 1, 576), device=dev)
    n0 = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd(q, k, k[..., :256], mask=mk.causal())
    pool = torch.zeros((4, 16, 1, 576), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        paged_attn(q[:, :1], pool, pool[..., :256],
                   torch.ones((1, 2), dtype=torch.int32, device=dev),
                   torch.full((1,), 20, dtype=torch.int32, device=dev))
    assert dict(build.LAUNCHES) == n0



PAIR_SCALE = 192 ** -0.5


def _pair_chunk(gen, dev, dtype, B, Tq, Tk, Hq, Hkv, v_kind):
    """q (B, Tq, Hq, 192), k (B, Tk, Hkv, 192) and v (B, Tk, Hkv, 128):
    a tensor of its own (``own``), the last 128 columns of a (.., 256)
    tensor (``kv``: materialised MLA's v beside k_nope) or k's first 128
    columns (``prefix``)."""
    q = _randn(gen, (B, Tq, Hq, 192), dtype, dev)
    k = _randn(gen, (B, Tk, Hkv, 192), dtype, dev)
    if v_kind == "own":
        v = _randn(gen, (B, Tk, Hkv, 128), dtype, dev)
    elif v_kind == "kv":
        v = _randn(gen, (B, Tk, Hkv, 256), dtype, dev)[..., 128:]
    else:
        v = k[..., :128]
    return q, k, v


PAIR_FLASH = [
    # (B, Tq, Tk, Hq, Hkv, mask, v): the fixed-slot prefill of two 4096-token
    # prompts (16 heads, causal, v beside k_nope); a chunk at q offset 768;
    # a ragged T of 1000; a window across tiles with ragged Tq and Tk; a
    # document mask with segment ids; GQA group 2 over k's prefix view;
    # rows with nothing to attend; a bidirectional chunk with offsets
    (2, 4096, 4096, 16, 16, mk.causal(), "kv"),
    (1, 256, 1024, 16, 16, mk.causal(rel_offset=768), "own"),
    (1, 1000, 1000, 16, 16, mk.causal(), "kv"),
    (1, 200, 333, 4, 4, mk.sliding_window(70, rel_offset=133), "own"),
    (2, 128, 256, 4, 4, mk.document(), "own"),
    (1, 192, 192, 8, 4, mk.causal(), "prefix"),
    (1, 128, 128, 2, 2, mk.causal(rel_offset=-64), "own"),
    (1, 64, 100, 2, 2, mk.MaskSpec(q_offset=10, kv_offset=3), "kv"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PAIR_FLASH,
                         ids=[f"B{c[0]}x{c[1]}x{c[2]}{c[5].kind}{c[6]}"
                              for c in PAIR_FLASH])
def test_pair_flash_kernel_matches_plain(dev, case, dtype):
    """Kernel A's pair route (q/k 192, v 128) against the plain version: o
    within the forward bar (bf16 also element by element), lse 1e-4, empty
    rows (0, NEG_INF); one launch, counted as ``flash_fwd_pair``."""
    B, Tq, Tk, Hq, Hkv, mask, v_kind = case
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = _pair_chunk(gen, dev, dtype, B, Tq, Tk, Hq, Hkv, v_kind)
    kw = {}
    if mask.document:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=dev), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    n0 = dict(build.LAUNCHES)
    o, lse = flash_fwd(q, k, v, mask=mask, scale=PAIR_SCALE, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd_pair"] == n0["flash_fwd_pair"] + 1
    assert all(build.LAUNCHES[n] == n0[n] for n in n0
               if n != "flash_fwd_pair")
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, scale=PAIR_SCALE, **kw)
    assert o.shape == (B, Tq, Hq, 128)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    live = lse_r > NEG_INF / 2
    torch.testing.assert_close(lse[live], lse_r[live], atol=1e-4, rtol=1e-4)
    assert bool((lse[~live] == NEG_INF).all())
    assert bool((o[~live] == 0).all())
    if dtype == torch.bfloat16:
        assert _rel_err(o, o_r) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pair_flash_route_is_deterministic(dev, dtype):
    """Two launches of the pair route on the serving chunk give bitwise
    equal o and lse (a fixed sweep order, no atomics)."""
    gen = torch.Generator(device=dev).manual_seed(32)
    q, k, v = _pair_chunk(gen, dev, dtype, 1, 256, 1024, 16, 16, "kv")
    m = mk.causal(rel_offset=768)
    o1, l1 = flash_fwd(q, k, v, mask=m, scale=PAIR_SCALE)
    o2, l2 = flash_fwd(q, k, v, mask=m, scale=PAIR_SCALE)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_pair_kernels_raise_on_other_pairs(dev):
    """Pairs outside ``PAIR_DIMS`` and ``LATENT_DIMS`` raise before a
    launch, in both dtypes; the backward takes the pair 192 / 128 and
    raises on any other, the latent pair included: no fallback."""
    n0 = dict(build.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        for dk, dv in ((192, 64), (160, 128), (128, 192), (256, 128)):
            q = torch.zeros((1, 64, 4, dk), device=dev, dtype=dt)
            v = torch.zeros((1, 64, 4, dv), device=dev, dtype=dt)
            with pytest.raises(ValueError, match="head dims"):
                flash_fwd(q, q, v, mask=mk.causal())
            lse = torch.zeros((1, 64, 4), device=dev)
            with pytest.raises(ValueError, match="head dims"):
                flash_bwd(q, q, v, v, lse, v, mask=mk.causal())
        q = torch.zeros((1, 64, 1, 576), device=dev, dtype=dt)
        with pytest.raises(ValueError, match="head dims"):
            flash_bwd(q, q, q[..., :512], q[..., :512],
                      torch.zeros((1, 64, 1), device=dev), q[..., :512],
                      mask=mk.causal())
    assert dict(build.LAUNCHES) == n0


PAIR_BWD = [
    # (B, Tq, Tk, H, mask, v): phase 14's training shape (16 heads, causal,
    # v beside k_nope); a ragged T; a document mask with segment ids; a
    # chunk at q offset 768; a window; rows with nothing to attend
    (1, 8192, 8192, 16, mk.causal(), "kv"),
    (1, 1000, 1000, 16, mk.causal(), "own"),
    (2, 256, 256, 4, mk.document(), "kv"),
    (1, 256, 1024, 16, mk.causal(rel_offset=768), "kv"),
    (1, 200, 333, 4, mk.sliding_window(70, rel_offset=133), "own"),
    (1, 128, 128, 2, mk.causal(rel_offset=-64), "own"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PAIR_BWD,
                         ids=[f"B{c[0]}x{c[1]}x{c[2]}{c[4].kind}{c[5]}"
                              for c in PAIR_BWD])
def test_pair_bwd_kernels_match_plain(dev, case, dtype):
    """Kernels C and D at q/k 192, v 128 (bf16 on the tensor cores, the
    pair library; float32 on the CUDA cores) against the plain backward on
    the same saved (o, lse): the backward bars (bf16 also row by row),
    the pruned sweep equal to the dense one, one launch of each counted,
    dk and dv contiguous in k's and v's shapes."""
    B, Tq, Tk, H, mask, v_kind = case
    gen = torch.Generator(device=dev).manual_seed(33)
    q, k, v = _pair_chunk(gen, dev, dtype, B, Tq, Tk, H, H, v_kind)
    do = _randn(gen, (B, Tq, H, 128), dtype, dev)
    kw = dict(mask=mask, scale=PAIR_SCALE)
    if mask.document:
        s = torch.sort(torch.randint(0, 4, (B, Tk), generator=gen,
                                     device=dev), dim=1)[0].to(torch.int32)
        kw.update(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    o, lse = flash_fwd(q, k, v, **kw)
    n0 = (build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"])
    got = flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["flash_bwd_dq"],
            build.LAUNCHES["flash_bwd_dkv"]) == (n0[0] + 1, n0[1] + 1)
    dense = flash_bwd(q, k, v, o, lse, do, prune=False, **kw)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}[dtype]
    for i, (a, d) in enumerate(zip(got, dense)):
        assert a.is_contiguous() and a.shape == (q, k, v)[i].shape
        assert float((a.float() - d.float()).abs().max()) <= 1e-6
    for h in range(0, H, 8):     # the plain version, 8 heads at a time
        sl = slice(h, h + 8)
        ref = chunk_attn_bwd_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 o[:, :, sl], lse[:, :, sl], do[:, :, sl],
                                 **kw)
        for a, r in zip(got, ref):
            a = a[:, :, sl]
            torch.testing.assert_close(a.float(), r.float(), atol=tol,
                                       rtol=tol)
            if dtype == torch.bfloat16:
                assert row_rel_err(a, r) <= 2e-2

def _pair_train_inputs(dev, seed):
    """Phase 14's backward shape: B 1, T 8192, 16 heads, causal, q/k 192, v
    the strided last 128 columns of a (.., 256) tensor, bf16, with (o, lse)
    from kernel A's pair route."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = _pair_chunk(gen, dev, torch.bfloat16, 1, 8192, 8192, 16, 16,
                          "kv")
    do = _randn(gen, (1, 8192, 16, 128), torch.bfloat16, dev)
    o, lse = flash_fwd(q, k, v, mask=mk.causal(), scale=PAIR_SCALE)
    return q, k, v, o, lse, do


def test_pair_bwd_bf16_route_is_deterministic(dev):
    """Two launches of kernels C and D's bf16 pair route at phase 14's shape
    give bitwise equal dq, dk and dv (a fixed sweep order, no atomics)."""
    q, k, v, o, lse, do = _pair_train_inputs(dev, 34)
    kw = dict(mask=mk.causal(), scale=PAIR_SCALE)
    first = flash_bwd(q, k, v, o, lse, do, **kw)
    second = flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_pair_bwd_dkv_is_one_launch_of_one_kernel(dev):
    """At q/k 192, v 128, kernel D is one launch of one kernel (sᵀ computed
    once per tile pair, no second pass), and kernel C one launch too: the
    profiler sees exactly one device kernel for each call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (_BwdPlan, _launch_dkv,
                                                     _launch_dq)
    q, k, v, o, lse, do = _pair_train_inputs(dev, 35)
    pl = _BwdPlan(q, k, v, o, lse, do, mk.causal(), None, None, None, True)
    _launch_dq(pl, PAIR_SCALE)     # builds and warms both
    _launch_dkv(pl, PAIR_SCALE)
    torch.cuda.synchronize()
    for launch, name in ((_launch_dq, "flash_bwd_dq_pair_kernel"),
                         (_launch_dkv, "flash_bwd_dkv_pair_kernel")):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            launch(pl, PAIR_SCALE)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type.name == "CUDA"]
        assert len(kernels) == 1 and name in kernels[0], kernels


def test_deepseek_engine_on_card_matches_cpu(dev):
    """Smoke deepseek-v2-lite-16b (float32, 2 layers, an MoE layer of 4
    experts) widened to the served latent (kv_lora 512, rope 64): the
    engine on the card — kernel A's latent route for chunks, kernel B over
    the latent pool — emits the same greedy streams as on the CPU, and so
    does n-gram speculation at depth 3."""
    import dataclasses

    from repro_torch.serve.speculative import SpecConfig
    base = smoke_config(get_config("deepseek-v2-lite-16b"))
    cfg = base.replace(attn=dataclasses.replace(
        base.attn, kv_lora_rank=512, qk_rope_head_dim=64))
    cpu = DecoderLM(cfg, device="cpu")
    params = cpu.init(0)
    params_d = tree_map(lambda t: t.to(dev), params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 40))
    kw = dict(max_batch=4, block_size=16, n_blocks=32,
              prefill_chunk_tokens=16)
    for spec in (None, SpecConfig(depth=3, mode="ngram")):
        build.reset_launches()
        out_d = Engine(DecoderLM(cfg, device=dev), params_d, spec=spec,
                       **kw).generate({"tokens": prompts}, 8)
        assert build.LAUNCHES["flash_fwd_latent"] > 0
        assert build.LAUNCHES["paged_decode"] > 0
        assert build.LAUNCHES["flash_fwd"] == 0
        out_c = Engine(cpu, params, spec=spec, **kw).generate(
            {"tokens": prompts}, 8)
        np.testing.assert_array_equal(out_d, out_c)


# ------------------------------------------ expert parallelism (7.3a)

def test_pair_routes_under_a_balanced_plan_step_mask(dev):
    """Kernels A, C and D's pair routes (q/k 192, v 128, 16 heads, bf16, v
    a strided view) under the mask the balanced plan gives one rank's
    off-diagonal step at P 4 (a whole kv chunk before the q chunk), with
    the executor's backward inputs (o zeros of v's width, delta passed
    in), against their plain versions at the kernel bars."""
    from repro_torch.core import schedule as sp
    plan = sp.build_plan("balanced", mk.causal(), 4, 1024)
    calls = [c for c in sp.rank_calls(plan, True) if not c[4].causal]
    assert calls
    km, c = calls[0][4], plan.chunk_len
    gen = torch.Generator(device=dev).manual_seed(37)
    q, k, v = _pair_chunk(gen, dev, torch.bfloat16, 1, c, c, 16, 16, "kv")
    do = _randn(gen, (1, c, 16, 128), torch.bfloat16, dev)
    kw = dict(mask=km, scale=PAIR_SCALE)
    n0 = dict(build.LAUNCHES)
    o, lse = flash_fwd(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1)
    zero = torch.zeros_like(do)
    got = flash_bwd(q, k, v, zero, lse, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert {n: build.LAUNCHES[n] - n0[n] for n in
            ("flash_fwd_pair", "flash_bwd_dq", "flash_bwd_dkv")} == {
        "flash_fwd_pair": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for h in range(0, 16, 8):
        sl = slice(h, h + 8)
        o_r, lse_r = chunk_attn_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    **kw)
        torch.testing.assert_close(o[:, :, sl].float(), o_r.float(),
                                   atol=2e-2, rtol=2e-2)
        live = lse_r > NEG_INF / 2
        torch.testing.assert_close(lse[:, :, sl][live], lse_r[live],
                                   atol=1e-4, rtol=1e-4)
        ref = chunk_attn_bwd_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 zero[:, :, sl], lse[:, :, sl],
                                 do[:, :, sl], delta=delta[:, :, sl], **kw)
        for a, r in zip(got, ref):
            a = a[:, :, sl]
            torch.testing.assert_close(a.float(), r.float(), atol=5e-2,
                                       rtol=5e-2)
            assert row_rel_err(a, r) <= 2e-2


def test_moe_apply_two_ranks_on_card_matches_one_rank(dev):
    """``moe_apply`` over 2 ranks sharing the card (cuda-ipc; each
    rank half the experts, the dispatch's two all_to_alls, the aux
    statistics summed over the ranks), float32 at capacity 4.0, against
    the one-rank dispatch on the card replaying the ranks' expert choices:
    each rank's rows and aux within 1e-5."""
    import _torch_moe_cases as MC
    from repro_torch.launch.world import spawn
    from repro_torch.models import moe as M
    res = sorted(spawn(MC.card_moe_world, 2, (), device=dev, timeout=300),
                 key=lambda r: r[0])
    assert {r[1] for r in res} == {"cuda-ipc"}
    assert all(r[5] > 0 for r in res)
    cfg = smoke_config(get_config(MC.ARCH))
    p, x = MC.card_moe_inputs(cfg)
    n = MC.MT // 2
    forced = torch.cat([torch.cat([r[4][b * n:(b + 1) * n] for r in res])
                        for b in range(MC.MB)]).to(dev)
    base = M.top_k

    def top_k(probs, k):
        return probs.gather(-1, forced), forced
    M.top_k = top_k
    try:
        y, aux = M.moe_apply({k: torch.from_numpy(v).to(dev)
                              for k, v in p.items()},
                             torch.from_numpy(x).to(dev), cfg)
    finally:
        M.top_k = base
    for r, (_, _, y_r, aux_r, _, _) in enumerate(res):
        torch.testing.assert_close(y_r, y[:, r * n:(r + 1) * n].cpu(),
                                   atol=1e-5, rtol=1e-5)
        assert abs(aux_r - float(aux)) <= 1e-5 * abs(float(aux))


def test_deepseek_v3_mtp_training_on_card_matches_plain(dev):
    """Smoke deepseek-v3-671b (2 layers and its MTP block, q_lora 32, 4
    experts) widened to the served MLA head dims (q/k 128 + 64, v 128:
    the pair routes of kernels A, C and D) in bf16 at T 256: the loss, ce,
    aux and mtp_ce and every gradient leaf through the kernels within the
    chunk backward's bf16 bars (2e-2 of each value, 5e-2 of each leaf's
    max |g|) of impl ``ref`` on the card, the plain run replaying the
    kernel run's expert choices (bf16 routers route near-ties either
    way); A, C and D launch once a layer and once for the MTP block."""
    import dataclasses

    from repro_torch.core.tree import leaves
    from repro_torch.models import moe as M
    base = smoke_config(get_config("deepseek-v3-671b"))
    cfg = base.replace(dtype="bfloat16", attn=dataclasses.replace(
        base.attn, head_dim=128, qk_rope_head_dim=64, v_head_dim=128))
    batch = SyntheticTokens(cfg, ShapeSpec("t", 256, 2, "train"),
                            device=dev).batch(0)
    init = DecoderLM(cfg, device=dev).init(0)
    real, calls = M.top_k, []

    def record(probs, k):
        out = real(probs, k)
        calls.append(out[1])
        return out

    def replay(probs, k):
        idx = calls.pop(0)
        return probs.gather(-1, idx), idx
    out = {}
    for impl, top_k in (("cuda", record), ("ref", replay)):
        model = DecoderLM(cfg, device=dev, impl=impl)
        params = trainable(tree_map(lambda t: t.clone(), init))
        build.reset_launches()
        M.top_k = top_k
        try:
            loss, met = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves(params))
        finally:
            M.top_k = real
        out[impl] = ({k: float(v.detach()) for k, v in met.items()} | {
            "loss": float(loss.detach())}, [g.float() for g in grads],
            dict(build.LAUNCHES))
    assert not calls
    (m_d, g_d, n_d), (m_r, g_r, _) = out["cuda"], out["ref"]
    for k in ("loss", "ce", "aux", "mtp_ce"):
        assert abs(m_d[k] - m_r[k]) <= 2e-2 * max(abs(m_r[k]), 1.0), \
            (k, m_d[k], m_r[k])
    for a, r in zip(g_d, g_r):
        assert float((a - r).abs().max()) <= 5e-2 * float(r.abs().max())
    for k in ("flash_fwd_pair", "flash_bwd_dq", "flash_bwd_dkv"):
        assert n_d[k] == cfg.n_layers + cfg.mtp_depth, (k, n_d)


# ------------------------------------- the cuda-ipc transport (4 ranks)

@pytest.fixture(scope="module")
def ipc_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import _torch_comm_cases as CC
    from repro_torch.launch.world import spawn
    return sorted(spawn(CC.transport_world, CC.RANKS, (), device="cuda",
                        timeout=300), key=lambda r: r["rank"])


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _same_bits(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def test_cuda_ipc_transfers_are_gloo_staged_bitwise(ipc_world):
    """On 4 ranks of one card: shifts, all_to_all, all_gather and
    broadcast_ under cuda-ipc give bitwise what gloo-staged gives, and
    every rank's meshes took the transports named."""
    for r in ipc_world:
        assert r["transports"] == ("cuda-ipc", "gloo-staged")
        for k in ("shift1", "shift3", "a2a", "gather", "bcast"):
            assert _same_bits(r["ipc"][k], r["staged"][k]), (r["rank"], k)


def test_cuda_ipc_all_reduce_is_rank_equal_and_float32_close(ipc_world):
    """``all_reduce_`` under cuda-ipc is bitwise the same on every rank, and
    each sum is within its float32 rounding bound (P · 2^-24 · Σ|x|, plus
    one rounding of the tensor's own dtype) of the float64 sum of the
    ranks' inputs."""
    for k in ("sum", "sum_big"):
        for r in ipc_world[1:]:
            assert _same_bits(r["ipc"][k], ipc_world[0]["ipc"][k]), k
    parts = [torch.stack([r["red"][i] for r in ipc_world])
             for i in range(len(ipc_world[0]["red"]))]
    parts.append(torch.stack([r["red_big"] for r in ipc_world]))
    got = ipc_world[0]["ipc"]["sum"] + [ipc_world[0]["ipc"]["sum_big"]]
    for g, p in zip(got, parts):
        exact = p.double().sum(0)
        ulp = 2.0 ** -8 if g.dtype == torch.bfloat16 else 2.0 ** -24
        bound = (p.shape[0] * 2.0 ** -24 * p.double().abs().sum(0)
                 + ulp * exact.abs())
        assert bool(((g.double() - exact).abs() <= bound).all())


def test_cuda_ipc_message_above_the_mailbox_cap_arrives_whole(ipc_world):
    """A shift, an all_to_all, an all_gather and an all-reduce larger than
    one mailbox slot go in pieces and arrive whole: bitwise gloo-staged's
    (the sum: bitwise on every rank)."""
    from repro_torch.parallel.comm import MAILBOX_CAP
    r0 = ipc_world[0]
    assert r0["ipc"]["gather_big"].numel() * 2 > MAILBOX_CAP
    for r in ipc_world:
        for k in ("shift_big", "a2a_big", "gather_big"):
            assert _same_bits(r["ipc"][k], r["staged"][k]), (r["rank"], k)
        assert _same_bits(r["ipc"]["sum_big"], r0["ipc"]["sum_big"])


D160_CASES = [
    # (B, Tq, Tk, H, mask, segments), zamba2's shared block (heads of 160,
    # one kv head a query head), each in float32 and bf16: a causal
    # prompt, a q-offset chunk, a ragged T, a document mask
    (1, 512, 512, 4, mk.causal(), False),
    (1, 128, 384, 2, mk.causal(rel_offset=256), False),
    (1, 200, 200, 2, mk.causal(), False),
    (2, 128, 128, 2, mk.document(), True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", D160_CASES,
                         ids=[c[4].kind + str(i)
                              for i, c in enumerate(D160_CASES)])
def test_d160_kernels_match_plain(dev, case, dtype):
    """Kernels A, C and D at head dim 160 (bf16: the pair libraries'
    <160, 160>; float32: ``flash_fwd.cu`` / ``flash_bwd.cu`` at 160)
    against their plain versions at the kernel bars, each launch counted
    under its own name (``flash_fwd_160`` ...) and nowhere else."""
    B, Tq, Tk, H, mask, segs = case
    gen = torch.Generator(device=dev).manual_seed(160)
    q = _randn(gen, (B, Tq, H, 160), dtype, dev)
    k = _randn(gen, (B, Tk, H, 160), dtype, dev)
    v = _randn(gen, (B, Tk, H, 160), dtype, dev)
    do = _randn(gen, (B, Tq, H, 160), dtype, dev)
    kw = {}
    if segs:
        s = torch.sort(torch.randint(0, 3, (B, Tk), generator=gen,
                                     device=dev), dim=1)[0].to(torch.int32)
        kw = dict(q_segments=s[:, :Tq].contiguous(), kv_segments=s)
    n0 = dict(build.LAUNCHES)
    o, lse = flash_fwd(q, k, v, mask=mask, **kw)
    got = flash_bwd(q, k, v, o, lse, do, mask=mask, **kw)
    torch.cuda.synchronize()
    want = {"flash_fwd_160": 1, "flash_bwd_dq_160": 1,
            "flash_bwd_dkv_160": 1}
    assert {n: build.LAUNCHES[n] - n0[n] for n in n0} == \
        {n: want.get(n, 0) for n in n0}
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask, **kw)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    ok = lse_r > NEG_INF / 2
    torch.testing.assert_close(lse[ok], lse_r[ok], atol=1e-4, rtol=1e-4)
    if dtype == torch.bfloat16:
        assert _rel_err(o, o_r) <= 3e-2
    ref = chunk_attn_bwd_ref(q, k, v, o, lse, do, mask=mask, **kw)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}[dtype]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            assert row_rel_err(a, r) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_refuse_head_dims_they_do_not_take(dev, dtype):
    """A head dim outside ``HEAD_DIMS`` (32, 64, 128, 160) — 96, 144, 176,
    256 — raises in A's and in C / D's wrappers before any launch; there is
    no fallback."""
    n0 = dict(build.LAUNCHES)
    for d in (96, 144, 176, 256):
        q = torch.zeros((1, 64, 2, d), device=dev, dtype=dtype)
        lse = torch.zeros((1, 64, 2), device=dev)
        with pytest.raises(ValueError, match="head dims"):
            flash_fwd(q, q, q, mask=mk.causal())
        with pytest.raises(ValueError, match="head dims"):
            flash_bwd(q, q, q, q, lse, q, mask=mk.causal())
    assert dict(build.LAUNCHES) == n0


WHISPER = [
    # whisper-tiny's cross-attention (6 heads of 64, the full mask): the
    # training shape, decoder T 4,096 against 1,536 frames (A forward, C
    # and D backward), and the decode's Tq = 1 against them (A)
    ("cross", 2, 4096, 1536),
    ("decode", 4, 1, 1536),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WHISPER, ids=[c[0] for c in WHISPER])
def test_whisper_cross_shapes_match_plain(dev, case, dtype):
    """Kernel A under the full mask at Tq ≠ Tk (and at Tq = 1), and C and
    D at the training cross shape, each launched once and held to its
    plain version at the kernel bars (bf16: A element by element to 3e-2,
    C and D row by row to 2e-2)."""
    _, B, Tq, Tk = case
    H, D, mask = 6, 64, mk.full()
    gen = torch.Generator(device=dev).manual_seed(24)
    q = _randn(gen, (B, Tq, H, D), dtype, dev)
    k = _randn(gen, (B, Tk, H, D), dtype, dev)
    v = _randn(gen, (B, Tk, H, D), dtype, dev)
    do = _randn(gen, (B, Tq, H, D), dtype, dev)
    n0 = dict(build.LAUNCHES)
    o, lse = flash_fwd(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == n0["flash_fwd"] + 1
    o_r, lse_r = chunk_attn_ref(q, k, v, mask=mask)
    torch.testing.assert_close(o.float(), o_r.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_r, atol=1e-4, rtol=1e-4)
    if dtype == torch.bfloat16:
        assert _rel_err(o, o_r) <= 3e-2
    if Tq == 1:
        return
    got = flash_bwd(q, k, v, o_r, lse_r, do, mask=mask)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["flash_bwd_dq"], build.LAUNCHES["flash_bwd_dkv"]) \
        == (n0["flash_bwd_dq"] + 1, n0["flash_bwd_dkv"] + 1)
    ref = chunk_attn_bwd_ref(q, k, v, o_r, lse_r, do, mask=mask)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}[dtype]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            assert row_rel_err(a, r) <= 2e-2


def test_kernel_sweep_times_the_kernels_not_a_no_op(dev):
    """``tune/sweep.sweep_kernels``' causal row at (1, 8192, 32, 128) bf16
    reads between 0.9x and 2.0x the kernels' own device time (CUDA events)
    at that shape: A for ``fwd``, C + D for ``bwd`` (chip_smoke.py phase 26
    (a)'s gate), and the sweep launched A, C and D."""
    from repro_torch.kernels.flash_attention import (_BwdPlan, _launch_dkv,
                                                     _launch_dq)
    from repro_torch.tune import sweep as tsw
    T, H, D = 8192, 32, 128
    data = tsw.new_table_data(dev)
    build.reset_launches()
    tsw.sweep_kernels(data, device=dev, shapes=[(T, D, D)], log=lambda *a: 0)
    assert all(build.LAUNCHES[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                                "flash_bwd_dkv"))
    wall = {r["op"]: r["wall_us"] / 1e3 for r in data["kernel"]
            if r["mask_kind"] == "causal"}
    gen = torch.Generator(device=dev).manual_seed(26)
    q, k, v, do = (_randn(gen, (1, T, H, D), torch.bfloat16, dev)
                   for _ in range(4))
    m = mk.causal()

    def device_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    a_ms = device_ms(lambda: flash_fwd(q, k, v, mask=m))
    o, lse = flash_fwd(q, k, v, mask=m)
    pl = _BwdPlan(q, k, v, o, lse, do, m, None, None, None, True)
    cd_ms = (device_ms(lambda: _launch_dq(pl, D ** -0.5))
             + device_ms(lambda: _launch_dkv(pl, D ** -0.5)))
    for op, ref in (("fwd", a_ms), ("bwd", cd_ms)):
        assert 0.9 <= wall[op] / ref <= 2.0, (op, wall[op], ref)
