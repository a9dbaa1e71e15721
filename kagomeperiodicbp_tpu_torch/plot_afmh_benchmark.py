"""Energy against D beside the published Kagome AFM Heisenberg values
(counterpart of the JAX package's scripts/plot_afmh_benchmark.py, with its
flags, tables and rows; reference: scripts/plot/afmh_benchmarking.py:26-42 of
the original code — the published simple-update (SU) and variational-update
(VU) numbers from the variPEPS literature, the reference BlockBP results, and
the best cells stored in ``--best-folder``).

    python -m kagomeperiodicbp_tpu_torch.plot_afmh_benchmark [--best-folder data/unit_cells/best]
        [--plot out.png]

It reads the stored energies (``utils/best_store.load_best``) and does no
tensor arithmetic, so it takes no ``--device``. matplotlib is imported only
under ``--plot``.
"""
from __future__ import annotations

import argparse

from .utils.best_store import load_best

PUBLISHED_SU = {2: -0.38620, 3: -0.41786, 4: -0.42323, 5: -0.42866,
                6: -0.43188, 7: -0.43313, 8: -0.43391}
PUBLISHED_VU = {2: -0.40454, 3: -0.42688, 4: -0.43038, 5: -0.43286,
                6: -0.43451, 7: -0.43527, 8: -0.43552}
REFERENCE_BLOCKBP = {2: -0.4046412208223448, 3: -0.41420215914597786,
                     4: -0.4202411110635614, 5: -0.42894009602652244}


def rows(best_folder: str) -> list:
    """(D, published SU, published VU, reference BlockBP or None, stored
    energy or None) for each D of the published tables."""
    out = []
    for D in sorted(PUBLISHED_SU):
        ours = load_best(D, best_folder)
        out.append((D, PUBLISHED_SU[D], PUBLISHED_VU[D], REFERENCE_BLOCKBP.get(D),
                    ours[1] if ours else None))
    return out


def table_lines(table: list) -> list:
    """The printed table, one line per D under a header."""
    lines = [f"{'D':>2} {'published SU':>14} {'published VU':>14} {'ref BlockBP':>14} {'this repo':>14}"]
    for D, su, vu, ref, mine in table:
        lines.append(f"{D:>2} {su:>14.5f} {vu:>14.5f} "
                     f"{ref if ref is not None else float('nan'):>14.10f} "
                     + (f"{mine:>14.10f}" if mine is not None else f"{'—':>14}"))
    return lines


def plot(table: list, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    Ds = [r[0] for r in table]
    ax.plot(Ds, [r[1] for r in table], "o-", label="published SU")
    ax.plot(Ds, [r[2] for r in table], "s-", label="published VU")
    ref = [r for r in table if r[3] is not None]
    ax.plot([r[0] for r in ref], [r[3] for r in ref], "^-", label="reference BlockBP")
    mine = [r for r in table if r[4] is not None]
    if mine:
        ax.plot([r[0] for r in mine], [r[4] for r in mine], "*-", ms=12, label="this repo")
    ax.set_xlabel("D")
    ax.set_ylabel("energy / site")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--best-folder", default="data/unit_cells/best")
    p.add_argument("--plot", default=None, help="optional output PNG path")
    args = p.parse_args(argv)

    table = rows(args.best_folder)
    print("\n".join(table_lines(table)))
    if args.plot:
        plot(table, args.plot)
        print(f"plot saved to {args.plot}")
    return table


if __name__ == "__main__":
    main()
