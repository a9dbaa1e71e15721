"""Accuracy against retained rank for the sketched single-layer swallow
(``ops/contract._swallow_ket_gram_split``, rank s = 2χ+32 by default): the
distance of the truncated outgoing BP message to a χ_hi double-layer oracle
as s varies around 2χ+32, the measurement behind the sketch's 1.4× bar
(counterpart of the JAX package's tools/sketch_rank_curve.py, with its flags
and row keys; ``--device`` added).

    python -m kagomeperiodicbp_tpu_torch.tools.sketch_rank_curve --D 6 --chi 24
    python -m kagomeperiodicbp_tpu_torch.tools.sketch_rank_curve --D 2 --chi 4 --device cpu --out /tmp/c.json

Protocol (as tests/test_single_layer.py::
test_gram_split_message_quality_under_truncation): a random cell at D and
random product messages at χ, drawn with numpy from ``--seed`` and
``--seed`` + 1 (the same on every device); m_exact the double-layer message
toward U at χ_hi (no blob, no sketch); d_norm the distance of the ordinary
single-layer message at χ; d(s) that of the sketched one at rank s
(KPBP_BLOB_LIMIT=1 sends every eligible swallow to the sketch,
KPBP_SKETCH_RANK pins s; both restored afterwards). One JSON row per path
and rank is appended to ``--out``, and a table is printed. It runs on the
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from ..algo import contraction as C
from ..convert import messages_from_numpy, numpy_product_messages, numpy_random_cell, unit_cell_from_numpy
from ..lattices import BlockSide
from ..measure import setup_device
from ..ops import mps as mpslib

FULL_RANK = 10 ** 6


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--D", type=int, default=6)
    p.add_argument("--N", type=int, default=2)
    p.add_argument("--chi", type=int, default=24)
    p.add_argument("--chi-hi", type=int, default=0, help="reference χ (default 3·χ)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="data/sketch_rank_curve_torch.json")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    return p.parse_args(argv)


@contextlib.contextmanager
def _env(**values):
    """Set (a str) or unset (None) environment variables for the duration."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def rank_curve(D: int, N: int, chi: int, chi_hi: int, seed: int, device) -> list:
    device = setup_device(device)
    cell = unit_cell_from_numpy(numpy_random_cell(D, seed), device)
    msgs = messages_from_numpy(numpy_product_messages(N, D, chi, seed + 1), device)
    toward = BlockSide.U

    m_exact, t_exact = _timed(lambda: C.outgoing_message(cell, msgs, N, D, chi_hi, chi, toward),
                              device)
    print(f"[rank_curve] D={D} χ={chi}: double-layer reference at χ_hi={chi_hi} in "
          f"{t_exact:.1f}s", flush=True)
    single = lambda: C.outgoing_message_single(cell, msgs, N, D, chi, chi, toward)  # noqa: E731
    with _env(KPBP_SKETCH_RANK=None, KPBP_BLOB_LIMIT=None):
        m_norm, t_norm = _timed(single, device)
    d_norm = float(mpslib.distance(m_norm, m_exact))
    print(f"[rank_curve] ordinary single-layer: d={d_norm:.3e} ({t_norm:.1f}s)", flush=True)
    rows = [{"D": D, "N": N, "chi": chi, "chi_hi": chi_hi, "seed": seed, "path": "ordinary",
             "rank": None, "distance": d_norm, "seconds": t_norm}]

    default_s = 2 * chi + 32
    ranks = sorted({chi // 2, chi, (3 * chi) // 2, 2 * chi, default_s, 3 * chi, 4 * chi, FULL_RANK})
    for s in ranks:
        with _env(KPBP_BLOB_LIMIT="1", KPBP_SKETCH_RANK=str(s)):
            m_s, dt = _timed(single, device)
        d_s = float(mpslib.distance(m_s, m_exact))
        tag = " <= DEFAULT (2χ+32)" if s == default_s else (" (full rank)" if s == FULL_RANK else "")
        ratio = d_s / max(d_norm, 1e-300)
        print(f"[rank_curve] sketch rank {s:>7}: d={d_s:.3e}  ratio d/d_norm={ratio:.3f}  "
              f"({dt:.1f}s){tag}", flush=True)
        rows.append({"D": D, "N": N, "chi": chi, "chi_hi": chi_hi, "seed": seed, "path": "sketch",
                     "rank": s, "distance": d_s, "ratio_vs_ordinary": ratio, "seconds": dt})
    return rows


def main(argv=None) -> list:
    args = parse_args(argv)
    rows = rank_curve(args.D, args.N, args.chi, args.chi_hi or 3 * args.chi, args.seed, args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    print(f"[rank_curve] {len(rows)} rows appended to {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
