"""Roofline arithmetic of the port (port of the reference
``analysis/roofline.py``'s pure-arithmetic half).

Two-term and three-term lower bounds, per device:

    compute_s    = FLOPs / PEAK_FLOPS
    memory_s     = HBM bytes / HBM_BW
    collective_s = link bytes / LINK_BW

The constants are one NVIDIA H100 SXM5's (NVIDIA H100 80GB HBM3 at
700 W, as ``nvidia-smi`` names the card).  ``schedule_cost_terms`` is
what ``DistAttnSpec(schedule="auto")`` ranks candidate schedules by
(``core/schedule.PlanCost.time_estimate``); the link rate decides between
a ring's neighbour shifts and a head all-to-all.  The functions read the
constants at call time, so a caller may patch them (a test does, with the
reference's TPU figures, to hold the port's choices to the reference's).

The reference's ``collective_stats`` parses XLA's optimized HLO text for
the collective ops of a compiled program; the port compiles no HLO, so it
has no counterpart.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s dense bf16 on the tensor cores
# (1,979 with 2:4 sparsity); NVIDIA H100 80GB HBM3, 700 W
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3; NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12
# NVIDIA H100 SXM5 data sheet: NVLink 4, 900 GB/s bidirectional, so 450 GB/s
# a direction; NVIDIA H100 80GB HBM3, 700 W
LINK_BW = 450e9


def model_flops(cfg, shape, *, chips: int) -> float:
    """MODEL_FLOPS a device: 6·N_active·tokens (train), 2·N·tokens
    (prefill), 2·N·batch (decode, one token)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.global_batch * shape.seq_len
    else:
        total = 2.0 * n * shape.global_batch
    return total / chips


def a2a_bytes(nbytes: float, k: int) -> float:
    """Link bytes a device of a tiled all-to-all over k devices: it keeps
    1/k of its payload and ships the rest, factor (k − 1)/k (the head
    scatter of ``core/schedule.plan2d_cost``)."""
    return nbytes * (k - 1) / max(k, 1)


def allgather_bytes(nbytes: float, k: int) -> float:
    """Link bytes a device of a tiled all-gather over k devices (ring
    algorithm): it receives the other k − 1 shards of ``nbytes`` each."""
    return nbytes * (k - 1)


def schedule_cost_terms(*, flops, comm_bytes):
    """Two-term time of a static schedule plan's cost
    (``core/schedule.PlanCost``): kernel FLOPs against the peak, hop-weighted
    link bytes against the link rate.  HBM traffic is the same for every
    schedule at this granularity (each streams the same chunks), so the
    memory term is left out."""
    ct = flops / PEAK_FLOPS
    kt = comm_bytes / LINK_BW
    return {"compute_s": ct, "collective_s": kt,
            "bound": "compute" if ct >= kt else "collective",
            "step_s_lower_bound": max(ct, kt)}


def roofline_terms(flops, bytes_accessed, coll_bytes):
    """Three-term roofline: compute, HBM and link seconds, the larger of
    them the lower bound."""
    ct = flops / PEAK_FLOPS
    mt = bytes_accessed / HBM_BW
    kt = coll_bytes / LINK_BW
    dom = max((ct, "compute"), (mt, "memory"), (kt, "collective"))
    return {"compute_s": ct, "memory_s": mt, "collective_s": kt,
            "bound": dom[1], "step_s_lower_bound": max(ct, mt, kt)}


# --------------------------------------------------------------------------
# Analytic attention-kernel costs, per device: the kernels keep score tiles
# on chip, so their HBM bytes are their operands' and their FLOPs the
# unmasked pairs'
# --------------------------------------------------------------------------

def _site(flops_fwd, flops_bwd, bytes_fwd, bytes_bwd, train):
    if train:
        return flops_fwd + flops_bwd, bytes_fwd + bytes_bwd
    return flops_fwd, bytes_fwd


def _self_attn_site(*, B_loc, T_glob, P, H, hd_qk, hd_v, Hkv, window,
                    causal, train, bpe=2):
    """One sequence-sharded self-attention site, per device."""
    if causal:
        w = min(window, T_glob) if window else T_glob
        pairs = B_loc * T_glob * (w / 2 if not window else w) / P
        steps = (P // 2 + 1) if not window else \
            min(P, max(1, -(-w // max(T_glob // P, 1))) + 1)
    else:
        pairs = B_loc * T_glob * T_glob / P
        steps = P
    T_loc = T_glob // P
    f_fwd = 2 * pairs * H * (hd_qk + hd_v)
    f_bwd = 2 * pairs * H * (3 * hd_qk + 2 * hd_v)
    kv_chunk = B_loc * T_loc * Hkv * (hd_qk + hd_v) * bpe
    q_bytes = B_loc * T_loc * H * hd_qk * bpe
    o_bytes = B_loc * T_loc * H * hd_v * bpe
    b_fwd = q_bytes + o_bytes + steps * kv_chunk
    b_bwd = 2 * q_bytes + 2 * o_bytes + 2 * steps * kv_chunk
    return _site(f_fwd, f_bwd, b_fwd, b_bwd, train)


def _decode_attn_site(*, B, S, seq_shards, H, hd_qk, hd_v, Hkv, window,
                      bpe=2):
    w = min(window, S) if window else S
    pairs = B * w / seq_shards
    flops = 2 * pairs * H * (hd_qk + hd_v)
    bytes_ = B * (w / seq_shards) * Hkv * (hd_qk + hd_v) * bpe
    return flops, bytes_


def _decode_dims(a):
    """(q/k width, v width, kv heads) of a paged decode: MLA attends its
    latent rows as one kv head, v their first kv_lora columns."""
    if a.is_mla:
        return a.kv_lora_rank + a.qk_rope_head_dim, a.kv_lora_rank, 1
    return a.head_dim, a.head_dim, a.n_kv_heads


def paged_decode_terms(cfg, *, batch, mean_len, block_size, bpe=2):
    """Roofline terms of one paged decode step (every layer) at mean
    context ``mean_len``: the kernel's FLOPs, the HBM bytes of whole blocks
    read through the table (``block_waste``: the partial last block's
    share), the table and q / o bytes; ``tok_s_bound`` the tokens/s it
    allows."""
    a = cfg.attn
    if a is None:
        return None
    hd_qk, hd_v, Hkv = _decode_dims(a)
    L_ = cfg.n_layers
    w = min(a.window, mean_len) if a.window else mean_len
    blocks = -(-w // block_size)
    toks_read = blocks * block_size
    flops = L_ * 2 * batch * w * a.n_heads * (hd_qk + hd_v)
    kv_bytes = L_ * batch * toks_read * Hkv * (hd_qk + hd_v) * bpe
    table_bytes = L_ * batch * blocks * 4
    qo_bytes = L_ * batch * a.n_heads * (hd_qk + hd_v) * bpe
    terms = roofline_terms(flops, kv_bytes + table_bytes + qo_bytes, 0.0)
    terms["block_waste"] = toks_read / max(w, 1) - 1.0
    terms["tok_s_bound"] = batch / max(terms["step_s_lower_bound"], 1e-12)
    return terms


def speculative_terms(cfg, *, batch, mean_len, depth, acceptance,
                      block_size, bpe=2, draft_cfg=None):
    """Expected throughput of speculative decoding at depth ``depth`` (K
    proposals a verify step) and per-token acceptance ``acceptance`` (a):
    E[tokens a step] = (1 − a^(K+1)) / (1 − a) (K + 1 at a = 1); the verify
    step prices as a paged decode of K + 1 rows a request over the same
    blocks; a ``draft_cfg``'s K decode steps add to the step's bound.
    Returns the vanilla and verify terms, E[tokens a step] and the
    speculative / vanilla tokens/s bound ratio."""
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError("acceptance must be in [0, 1]")
    if depth < 0:
        raise ValueError("depth must be >= 0")
    K = int(depth)
    a = float(acceptance)
    exp_tokens = (K + 1.0 if a >= 1.0
                  else (1.0 - a ** (K + 1)) / (1.0 - a))
    vanilla = paged_decode_terms(cfg, batch=batch, mean_len=mean_len,
                                 block_size=block_size, bpe=bpe)
    if vanilla is None:
        return None
    at = cfg.attn
    hd_qk, hd_v, Hkv = _decode_dims(at)
    w = min(at.window, mean_len) if at.window else mean_len
    blocks = -(-w // block_size)
    toks_read = blocks * block_size
    L_ = cfg.n_layers
    flops = L_ * 2 * batch * (K + 1) * w * at.n_heads * (hd_qk + hd_v)
    kv_bytes = L_ * batch * toks_read * Hkv * (hd_qk + hd_v) * bpe
    qo_bytes = L_ * batch * (K + 1) * at.n_heads * (hd_qk + hd_v) * bpe
    table_bytes = L_ * batch * blocks * 4
    verify = roofline_terms(flops, kv_bytes + qo_bytes + table_bytes, 0.0)
    step_lb = verify["step_s_lower_bound"]
    draft_lb = 0.0
    if draft_cfg is not None and K > 0:
        d = paged_decode_terms(draft_cfg, batch=batch, mean_len=mean_len,
                               block_size=block_size, bpe=bpe)
        if d is not None:
            draft_lb = K * d["step_s_lower_bound"]
            step_lb += draft_lb
    tok_s_spec = batch * exp_tokens / max(step_lb, 1e-12)
    return {
        "depth": K,
        "acceptance": a,
        "expected_tokens_per_step": exp_tokens,
        "vanilla": vanilla,
        "verify": verify,
        "draft_s_lower_bound": draft_lb,
        "step_s_lower_bound": step_lb,
        "tok_s_bound": tok_s_spec,
        "speedup_bound": tok_s_spec / max(vanilla["tok_s_bound"], 1e-12),
    }


def prefix_cache_terms(cfg, *, prompt_len, hit_rate, chunk_tokens=0,
                       bpe=2):
    """Prefill bounds of one request under the prefix cache: a share
    ``hit_rate`` of the prompt's KV is reused, so only the other query rows
    run (they still attend the whole context); ``chunk_tokens`` spreads the
    cold prefill over that many engine steps."""
    n_params = cfg.active_param_count()
    a = cfg.attn
    H = a.n_heads if a else 0
    hd = ((a.kv_lora_rank + a.qk_rope_head_dim) if a and a.is_mla
          else (a.head_dim if a else 0))

    def prefill_cost(n_cached):
        q = prompt_len - n_cached
        flops = 2 * n_params * q
        if a:
            flops += cfg.n_layers * 2 * q * prompt_len * H * 2 * hd
        bytes_ = n_params * bpe + q * cfg.d_model * bpe \
            + 2 * prompt_len * (a.n_kv_heads if a and not a.is_mla
                                else 1) * hd * bpe
        return roofline_terms(flops, bytes_, 0.0)

    cold = prefill_cost(0)
    cached = prefill_cost(int(hit_rate * prompt_len))
    n_chunks = (max(1, -(-prompt_len // chunk_tokens)) if chunk_tokens
                else 1)
    saved = 1 - (cached["compute_s"] / cold["compute_s"]
                 if cold["compute_s"] else 0.0)
    return {
        "ttft_s_lower_bound_cold": cold["step_s_lower_bound"],
        "ttft_s_lower_bound_cached": cached["step_s_lower_bound"],
        "prefill_flops_saved_frac": saved,
        "n_chunks_cold": n_chunks,
        "blocks_saved_frac": hit_rate,
    }


def attention_analytic(cfg, shape, *, seq_shards, batch_shards):
    """The analytic kernel (FLOPs, bytes) a device of every attention site
    of one (config, shape): a decoder's self-attention layers and its MTP
    blocks, a hybrid's shared block (one site every ``hybrid_period``
    layers, none in an SSM), and the encoder–decoder's encoder
    self-attention (bidirectional, replicated over the sequence ranks) and
    decoder cross-attention (queries sharded, the encoder's keys
    replicated).  MLA's decode attends its latent rows."""
    a = cfg.attn
    if a is None:
        return 0.0, 0.0
    B_loc = max(shape.global_batch // batch_shards, 1)
    is_mla = a.is_mla
    hd_qk = (a.qk_nope_head_dim + a.qk_rope_head_dim) if is_mla \
        else a.head_dim
    hd_v = (a.v_head_dim or a.head_dim) if is_mla else a.head_dim
    Hkv = a.n_heads if is_mla else a.n_kv_heads
    n_self = cfg.n_layers + (cfg.mtp_depth or 0)
    if cfg.arch_type == "hybrid":
        n_self = cfg.n_layers // cfg.hybrid_period
    if cfg.arch_type == "ssm":
        n_self = 0
    audio = cfg.arch_type == "audio"
    F = cfg.n_audio_frames
    fl = by = 0.0
    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        T = shape.seq_len
        if n_self:
            f, b = _self_attn_site(B_loc=B_loc, T_glob=T, P=seq_shards,
                                   H=a.n_heads, hd_qk=hd_qk, hd_v=hd_v,
                                   Hkv=Hkv, window=a.window, causal=True,
                                   train=train)
            fl += n_self * f
            by += n_self * b
        if audio:
            f, b = _self_attn_site(B_loc=B_loc, T_glob=F, P=1, H=a.n_heads,
                                   hd_qk=hd_qk, hd_v=hd_v, Hkv=a.n_heads,
                                   window=0, causal=False, train=train)
            fl += cfg.n_enc_layers * f
            by += cfg.n_enc_layers * b
            pairs = B_loc * (T // seq_shards) * F
            f_fwd = 2 * pairs * a.n_heads * 2 * a.head_dim
            b_fwd = B_loc * F * a.n_heads * a.head_dim * 2 * 2
            fl += cfg.n_layers * f_fwd * (2.5 if train else 1.0)
            by += cfg.n_layers * b_fwd * (2.0 if train else 1.0)
        return fl, by
    if is_mla:
        hd_qk, hd_v, Hkv = _decode_dims(a)
        shards = (seq_shards * batch_shards if shape.global_batch == 1
                  else seq_shards)
    else:
        shards = seq_shards
    f, b = _decode_attn_site(B=shape.global_batch, S=shape.seq_len,
                             seq_shards=shards, H=a.n_heads, hd_qk=hd_qk,
                             hd_v=hd_v, Hkv=Hkv, window=a.window)
    fl += n_self * f
    by += n_self * b
    if audio:
        B = shape.global_batch
        fl += cfg.n_layers * 2 * B * F * a.n_heads * 2 * a.head_dim
        by += cfg.n_layers * B * F * a.n_heads * a.head_dim * 2 * 2
    return fl, by
