"""How far an SSM or hybrid model's recurrent decode parts from its training
forward in bf16, and how much of that is bf16 rounding: the readings
behind the bf16 decode gate of ``chip_smoke.py``'s phase 21.

For each architecture and depth, the seed-21 weights (drawn in float32,
the bf16 model's a cast of them) run a 64-token prompt through the
training trunk (every position's logits) and through ``DecoderLM.decode``
token by token from the empty cache, in float32 and in bf16.  Each
reading is the largest, over the prompt's positions, of max |Δlogit| over
the second run's max |logit| at that position:

  * ``dec32~fwd32``  the two paths in float32 (phase 21's gate: ≤ 0.05);
  * ``dec16~fwd16``  the two paths in bf16;
  * ``fwd16~fwd32``  the training forward's own bf16 rounding;
  * ``dec16~dec32``  the decode's own bf16 rounding;
  * ``order16``      the bf16 training forward at a quarter of its SSD
    chunk (16 against the 64 tokens in one chunk at full size): the same
    arithmetic summed in another float32 order, so what rounding order alone moves after bf16 (``order32``:
    the same in float32);
  * ``state16``      a planted fault seen only in bf16: the decode with
    its float32 state rounded to bf16 after every step, against
    ``dec32``.

    python tools/ssm_bf16_drift.py [--arch mamba2-2.7b zamba2-2.7b]
        [--layers 8 64] [--device cuda] [--smoke]

``--layers`` cuts each model's depth (a hybrid's to a multiple of its
period; 0 or more than its depth: the whole model).  ``--smoke`` runs the
smoke configs (a CPU check of the script).  Prints the card's name and
power limit when it runs on one.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
from repro_torch.core.config import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import empty_decode_cache  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.ssm import ssm_decode_step  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

SEED, PROMPT = 21, 64


def trunk_logits(model, params, tokens):
    """The training trunk's logits at every position (B, T, V), float32."""
    with torch.no_grad():
        h, cos, sin, _, _ = model._trunk_input(params, tokens)
        return model._head(params, model._ssm_trunk(params, h, cos,
                                                    sin)).float()


def decode_logits(model, params, tokens, step=None):
    """The recurrent decode's logits at every position of ``tokens`` fed
    one by one from the empty cache (T, V), float32; ``step`` replaces
    ``ssm_decode_step`` (a planted fault)."""
    cfg, dev = model.cfg, model.device
    cache = empty_decode_cache(cfg, 1, tokens.shape[1], dev)
    TF.ssm_decode_step = step or ssm_decode_step
    try:
        with torch.no_grad():
            rows = [model.decode(params, cache, tokens[:, t:t + 1],
                                 torch.full((1,), t, dtype=torch.int32,
                                            device=dev))[0, 0].float()
                    for t in range(tokens.shape[1])]
    finally:
        TF.ssm_decode_step = ssm_decode_step
    return torch.stack(rows)


def state16(p, x, state, tail, cfg):
    y, state, tail = ssm_decode_step(p, x, state, tail, cfg)
    return y, state.to(torch.bfloat16).float(), tail


def cast(tree, dtype, name=None):
    """``tree`` in ``dtype``, the leaves the model keeps in float32 kept."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(x, dtype, name) for x in tree]
    return tree if name in TF._FLOAT32_LEAVES else tree.to(dtype)


def rel(got, ref):
    """Over positions: the largest max |Δ| / max |ref| of a row."""
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


def readings(cfg, dev):
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (1, PROMPT)).astype(np.int32)).to(dev)
    c32 = cfg.replace(dtype="float32")
    base = DecoderLM(c32, dev).init(seed=SEED)
    out, fwd, dec = {}, {}, {}
    for dt, c in (("32", c32), ("16", cfg.replace(dtype="bfloat16"))):
        params = base if dt == "32" else cast(base, torch.bfloat16)
        model = DecoderLM(c, dev)
        fwd[dt] = trunk_logits(model, params, prompt)[0]
        dec[dt] = decode_logits(model, params, prompt)
        chunk = max(1, min(c.ssm.chunk, PROMPT) // 4)
        fine = c.replace(ssm=dataclasses.replace(c.ssm, chunk=chunk))
        out["order" + dt] = rel(trunk_logits(DecoderLM(fine, dev), params,
                                             prompt)[0], fwd[dt])
        if dt == "16":
            out["state16"] = rel(decode_logits(model, params, prompt,
                                               state16), dec["32"])
        del params, model
    out["dec32~fwd32"] = rel(dec["32"], fwd["32"])
    out["dec16~fwd16"] = rel(dec["16"], fwd["16"])
    out["fwd16~fwd32"] = rel(fwd["16"], fwd["32"])
    out["dec16~dec32"] = rel(dec["16"], dec["32"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["mamba2-2.7b", "zamba2-2.7b"])
    ap.add_argument("--layers", nargs="+", type=int, default=[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)
    keys = ("dec32~fwd32", "dec16~fwd16", "fwd16~fwd32", "dec16~dec32",
            "order16", "order32", "state16")
    print("arch layers " + " ".join(keys), flush=True)
    for arch in a.arch:
        full = get_config(arch)
        if a.smoke:
            full = smoke_config(full)
        period = full.hybrid_period if full.arch_type == "hybrid" else 1
        for n in a.layers:
            n = full.n_layers if n <= 0 else min(n, full.n_layers)
            n -= n % period
            t0 = time.perf_counter()
            r = readings(full.replace(n_layers=n), dev)
            print(f"{arch} {n} " + " ".join(f"{r[k]:.4e}" for k in keys)
                  + f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
