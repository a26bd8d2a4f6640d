#!/usr/bin/env python3
"""Reproduce the reference's integration-test truncation-error scaling
table (reference: tests/integration_test/integration_test1.py): the
analytic potential-field case at 9 resolutions, reporting
dx | Ea_max | Ea_avg | Eb_max | Eb_avg | time, plus power-law fits
(expected index ~2).

Usage:
  python examples/integration_scaling.py [--mean] [--scales 1 2 3]
      [--precision auto|fp64|mixed]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ndsm_tpu import vector_potential
from ndsm_tpu.utils.testing import potential_field_case, power_law_fit

SCALE_FACTORS = [1, 2, 3, 3.5, 4, 4.5, 7.3, 8, 10]  # integration_test1.py:107


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mean", action="store_true", help="mean-difference metric")
    ap.add_argument("--scales", type=float, nargs="*", default=SCALE_FACTORS)
    ap.add_argument("--precision", default="auto")
    ap.add_argument(
        "--warm",
        action="store_true",
        help="run one untimed call per size first so the timed call measures "
        "steady-state (compile + backend init excluded, as in bench.py)",
    )
    ap.add_argument(
        "--out",
        default=None,
        help="also write the table to FILE in the reference's results_test "
        "format (tests/integration_test/results_test1.txt)",
    )
    ap.add_argument(
        "--fast",
        action="store_true",
        help="reduced-transfer path: host-side curl + split16 wire "
        "format (golden digits unchanged); timings then include that "
        "download path instead of raw float64 downloads",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="mixed_inner_max=1: the reference's exact iterate sequence "
        "(the default defect groups move exactly one 18-table entry by "
        "one final digit)",
    )
    args = ap.parse_args()

    base = np.array([22, 22, 22])
    names = ["Ea_max", "Ea_avg", "Eb_max", "Eb_avg", "Time"]
    dx = np.zeros(len(args.scales))
    errors = np.zeros((len(names), len(args.scales)))

    for i, scale in enumerate(args.scales):
        nshape = (scale * base).astype(int)
        nz, ny, nx = nshape
        x = np.linspace(0, 1, nx)
        dx[i] = x[1] - x[0]
        y = np.arange(ny) * dx[i]
        z = np.arange(nz) * dx[i]
        Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
        A1, b1 = potential_field_case(X, Y, Z)

        kw = {}
        if args.fast or args.strict:
            from ndsm_tpu import Options

            kw["options"] = Options(
                mean=args.mean,
                precision=args.precision,
                host_curl=args.fast,
                fetch_encoding="split16" if args.fast else "f64",
                mixed_inner_max=1 if args.strict else 6,
            )
        if args.warm:
            vector_potential(
                x, y, z, b1.copy(), mean=args.mean, precision=args.precision,
                **kw,
            )
        t1 = time.time()
        ierr, A2, b2 = vector_potential(
            x, y, z, b1.copy(), mean=args.mean, precision=args.precision, **kw
        )
        dt = time.time() - t1

        Eb = np.linalg.norm(b1 - b2, axis=0)
        Ea = np.linalg.norm(A1 - A2, axis=0)
        evec = [Ea.max(), Ea.mean(), Eb.max(), Eb.mean(), dt]
        errors[:, i] = evec
        print(
            "{:.5e}\t{:.5e}\t{:.5e}\t{:.5e}\t{:.5e}\t{:.5e}".format(dx[i], *evec),
            flush=True,
        )
        if ierr != 0:
            print(f"  WARNING: ierr={ierr}", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as fh:
            fh.write("#\n# Results: integration_scaling.py{}\n#\n".format(
                " (mean metric)" if args.mean else ""
            ))
            fh.write('# ["Ea_max","Ea_avg","Eb_max","Eb_avg","Time"]\n#\n')
            for i in range(len(args.scales)):
                fh.write(
                    "{:.5e}\t{:.5e}\t{:.5e}\t{:.5e}\t{:.5e}\t{:.5e}\n".format(
                        dx[i], *errors[:, i]
                    )
                )

    if len(args.scales) >= 2:
        for i, name in enumerate(names):
            gamma, _, _ = power_law_fit(dx, errors[i, :])
            print("Power-law index {:s}: {:g}".format(name, gamma))


if __name__ == "__main__":
    main()
