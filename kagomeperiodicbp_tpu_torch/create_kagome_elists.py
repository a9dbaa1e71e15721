"""Dump the Kagome block's edge list (node pairs per edge, boundary legs per
side) as JSON, for external tools and cross-implementation comparisons
(counterpart of the JAX package's scripts/create_kagome_elists.py, with its
flags and keys).

    python -m kagomeperiodicbp_tpu_torch.create_kagome_elists -N 2 [--out elist.json]

It reads the block's graph only and does no tensor arithmetic, so it takes
no ``--device``.
"""
from __future__ import annotations

import argparse
import json

from .lattices import BlockSide, KagomeBlock


def elists(N: int) -> dict:
    """The block's node count, flavours, edges (v < n) and boundary legs."""
    block = KagomeBlock.build(N)
    edges = []
    for v in range(block.n_nodes):
        for leg in range(4):
            n = int(block.neighbors[v, leg])
            if n > v:
                edges.append([v, n])
    boundary = {BlockSide(s).name: [[int(v), int(leg)] for v, leg in block.boundary_legs(BlockSide(s))]
                for s in range(6)}
    return {"N": N, "n_nodes": block.n_nodes, "flavors": [int(k) for k in block.kinds],
            "edges": edges, "boundary_legs": boundary}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-N", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    data = elists(args.N)
    text = json.dumps(data, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return data


if __name__ == "__main__":
    main()
