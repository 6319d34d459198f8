"""Graph-only curve fitting test app (reference: tests/minimal_graph_only).

Fits y = a·cos(bx) + b·sin(ax) with ground truth (a,b) = (100, 102) and a
near-truth initialization (main.cpp:20-58).
"""

import numpy as np

import opt_tpu_torch as ot
from opt_tpu_torch.examples.common import example_argparser, host, setup_backend
from opt_tpu_torch.models.specs import curve_fitting


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    device = setup_backend(args)
    a_t, b_t = 100.0, 102.0
    N = 512
    rng = np.random.RandomState(0)
    xs = rng.rand(N) * 0.1
    ys = a_t * np.cos(b_t * xs) + b_t * np.sin(a_t * xs)
    inputs = {
        "funcParams": np.array([[99.6, 102.4]], np.float32),
        "data": np.stack([xs, ys], -1).astype(np.float32),
        "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)},
    }
    plan = ot.Problem(curve_fitting).plan(
        dims={"N": N, "U": 1}, kind="LMGPU", device=device, double_precision=args.double
    )
    res = plan.solve(inputs, nIterations=5 if args.small else 30, lIterations=50)
    a, b = host(res.unknowns["funcParams"])[0]
    print(f"fit: a={a:.4f} b={b:.4f} (truth {a_t}, {b_t}); final cost {res.final_cost:.6g}")
    return res


if __name__ == "__main__":
    main()
