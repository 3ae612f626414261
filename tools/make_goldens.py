"""(Re)generate the golden-image suite under tests/goldens/.

Run on CPU after an INTENTIONAL rendering change:
  JAX_PLATFORMS=cpu python tools/make_goldens.py [name ...]
      # default: all goldens

REGENERATION CHECKLIST (a perf refactor must not silently regenerate
goldens).  Before committing regenerated files:
  1. tests/test_integrator.py + tests/test_materials.py must pass —
     they anchor the MC means to the NumPy reference tracer, so a
     regeneration can only move goldens within estimator noise.
  2. Diff the per-golden film means printed below against the previous
     run; any change > ~1% at equal (spp, seed) is a real regression,
     not an FP tie flip.
  3. Name the cause in the commit message (which op reassociated /
     which near-tie winner flipped).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np

from mrt.runtime.render import render
import golden_scenes as G

only = set(sys.argv[1:])
unknown = only - set(G.FACTORIES)
if unknown:
    raise SystemExit(f"unknown goldens: {sorted(unknown)}; "
                     f"have {sorted(G.FACTORIES)}")

out_dir = os.path.join(os.path.dirname(__file__), "..", "tests",
                       "goldens")
os.makedirs(out_dir, exist_ok=True)
for name, factory in G.FACTORIES.items():
    if only and name not in only:
        continue
    scene, camera = factory()
    film = render(scene, camera, G.SIZE, G.SIZE, spp=G.SPP,
                  max_depth=G.DEPTH, seed=G.SEED)
    path = os.path.join(out_dir, f"{name}_{G.SIZE}.npz")
    np.savez_compressed(path, sum=np.asarray(film.sum),
                        depth=np.asarray(film.depth_sum))
    print(f"{name}: mean={np.asarray(film.mean()).mean():.4f} -> {path}")
