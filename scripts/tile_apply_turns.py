"""K5, the sharded solve's per-tile apply, of two checkouts on one card, in
turns: OTHER, this tree, this tree, OTHER.

    python3 scripts/tile_apply_turns.py OTHER_CHECKOUT

Each turn is a process started in its checkout, which builds that
checkout's library (its own build/ directory) and times its tile_apply
kernel with that checkout's chip_smoke.time_tile_apply (device ms an apply
by the profiler) on the first 256x256 tile of a 2x2 split of poisson
512x512x4, image_warping 512x512x3 and poisson 512x512x4 with bfloat16
fields, after holding it bitwise against the plain twin there. Each timing
prints one JSON line tagged with its turn. Needs one CUDA card; a second
copy of the repository can be made with `git archive` into a directory that
.gitignore lists.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

TURN = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from opt_tpu_torch.models.specs import image_warping, poisson_image_editing
from opt_tpu_torch.ops import sharded_cg
from opt_tpu_torch.ops._build import build_library
info = build_library()
print(json.dumps({{"turn": "{tag}", "built": info["built"], "build_s": info["seconds"]}}),
      flush=True)
gpu, n = cs.gpu_line(), 512
for label, spec, inp, kw in (
        ("poisson", poisson_image_editing, cs.bench_poisson_inputs(n), {{}}),
        ("image_warping", image_warping, cs.bench_image_warping_inputs(n), {{}}),
        ("poisson bf16", poisson_image_editing, cs.bench_poisson_inputs(n),
         {{"coefficient_dtype": "bfloat16"}})):
    meta = cs.system(spec, cs._grid(n), inp, **kw)[0]
    tiles, halo, _p, pad = cs.tiles_of(meta)
    Ft, pe = cs.tile_operands(meta, tiles[0], halo, pad)
    k = sharded_cg.tile_apply_kernel(Ft, meta["triples"], pe, *halo)
    if not torch.equal(k, sharded_cg.tile_apply_reference(Ft, meta["triples"], pe, *halo)):
        raise SystemExit(f"{{label}}: not bitwise the twin")
    cs.time_tile_apply("{tag} " + label, meta, gpu)
"""


def turn(tree: Path, tag: str) -> None:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", TURN.format(tag=tag)], cwd=tree, check=True)
    print(json.dumps({"turn": tag, "tree": str(tree), "turn_s": time.perf_counter() - t0}),
          flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    other, here = Path(sys.argv[1]).resolve(), Path(__file__).resolve().parents[1]
    for tree, tag in ((other, "other"), (here, "this"), (here, "this"), (other, "other")):
        turn(tree, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
