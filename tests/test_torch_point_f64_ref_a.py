"""The port's float64 Point step against JAX float64 ``spec.step`` on
PointUMaze-v0: the robot alone (``physics/point_world.rk4_step``), from
seeded states anywhere in the free cells (``_torch_point_f64``)."""

import _torch_threads  # noqa: F401  (one PyTorch intra-op thread)
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

import _torch_point_f64 as pf  # noqa: E402
from mujoco_maze_tpu_torch import registry  # noqa: E402

from _torch_threads import one_intraop_thread  # noqa: E402,F401


def test_f64_step_matches_jax_umaze():
    import torch

    spec = registry.make_spec("PointUMaze-v0", dtype=torch.float64,
                              device="cpu")
    q, v, a = pf.free_cell_states(spec, pf.B, 5)
    errs, far, flips = pf.compare("PointUMaze-v0", q, v, a)
    print(f"median {np.median(errs):.3g}, max {errs.max():.3g}, bit-equal "
          f"{int((errs == 0).sum())} of {len(errs)}, contact-free "
          f"{int(far.sum())} (max {errs[far].max() if far.any() else 0:.3g}); "
          f"env-steps whose XLA solve differs in its bits {flips['diff']}, "
          f"whose line search then takes another branch {flips['flip']}, "
          f"where that moves the solve's result {flips['moved']}")
    assert np.median(errs) < 1e-9
    assert far.sum() >= 10
    assert errs[far].max() <= 1e-12
    assert flips["moved"] == 0
