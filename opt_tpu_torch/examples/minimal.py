"""Minimal smoothing test app (reference: tests/minimal).

512x512 laplacian smoothing of random noise; writes before/after PNGs for
eyeball verification (tests/minimal/main.cpp:10-62).
"""

import numpy as np

import opt_tpu_torch as ot
from opt_tpu_torch.examples.common import example_argparser, host, setup_backend
from opt_tpu_torch.models.specs import laplacian
from opt_tpu_torch.utils.io import save_image


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    device = setup_backend(args)
    n = 64 if args.small else 512
    rng = np.random.RandomState(0)
    noisy = rng.rand(n, n).astype(np.float32)
    plan_kw = {}
    if args.timing:
        plan_kw["init_params"] = ot.InitializationParameters(
            collect_per_kernel_timing=True
        )
    plan = ot.Problem(laplacian).plan(
        dims={"W": n, "H": n}, device=device, double_precision=args.double, **plan_kw
    )
    res = plan.solve(
        {"X": noisy.copy(), "A": noisy},
        nIterations=1 if args.small else 10,
        lIterations=10 if args.small else 50,
    )
    save_image("minimal_before.png", noisy)
    save_image("minimal_after.png", host(res.unknowns["X"])[..., 0])
    print(f"final cost: {res.final_cost:.8g}")
    print("wrote minimal_before.png / minimal_after.png")
    return res


if __name__ == "__main__":
    main()
