"""The port's float64 Point step against JAX float64 ``spec.step`` on
PointPush-v0: the robot and the block in one coupled solve
(``physics/point_world.forward_world``), from seeded states in the free
cells and from contact states on the block (``_torch_point_f64``)."""

import _torch_threads  # noqa: F401  (one PyTorch intra-op thread)
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

import _torch_point_f64 as pf  # noqa: E402
import _torch_point_quasi as pq  # noqa: E402
from mujoco_maze_tpu_torch import registry  # noqa: E402
from mujoco_maze_tpu_torch.ops import point_kernel as pk  # noqa: E402

from _torch_threads import one_intraop_thread  # noqa: E402,F401


def test_f64_step_matches_jax_push():
    import torch

    spec = registry.make_spec("PointPush-v0", dtype=torch.float64,
                              device="cpu")
    assert spec.point_block_world is not None
    q1, v1, a1 = pf.free_cell_states(spec, 2 * pf.B, 6, no_spin_every=2)
    _, qspec = pq.specs("PointPush-v0")
    q2, v2, _, a2 = (x.astype(np.float64) for x in
                     pk.quasi_states(qspec, pf.B // 2, 6))
    q, v, a = (np.concatenate(x) for x in ((q1, q2), (v1, v2), (a1, a2)))
    b = spec.block_runtimes[0]

    ms = spec.structure
    wc = np.asarray(ms.block_pos).reshape(-1, 3)[:, :2]
    wh = np.asarray(ms.block_size).reshape(-1, 3)[:, :2]

    def block_far(qpos, reach):
        """The robot out of the block's reach, the block out of the walls
        (no block-wall row: the overlap along x or y not positive)."""
        c = np.asarray(b.body_pos[:2]) + qpos[:, 3:5]
        d = np.maximum(np.abs(qpos[:, :2] - c) - np.asarray(b.half[:2]), 0)
        over = wh[None] + np.asarray(b.half[:2]) - np.abs(c[:, None] - wc[None])
        clear = (over.min(-1) <= 0.0).all(1)
        return (np.sqrt((d * d).sum(1)) > reach) & clear

    errs, far, flips = pf.compare("PointPush-v0", q, v, a, block_far)
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
