"""The card's measured fp32 ceiling (port of the measuring half of
``mujoco_maze_tpu.utils.roofline``).

:func:`fp32_peak_flops` times ``csrc/roofline.cu::fma_peak_kernel``,
independent ``x = a x + b`` chains held in registers (two operations per
fused multiply-add, no memory traffic in the timed loop), with CUDA events,
and returns the best FLOP/s over a few repetitions: a ceiling measured on
the card at hand, beside the data sheet's figure.  ``fma_chain`` is the
kernel's wrapper; ``fma_chain_plain`` its plain PyTorch version, which
rounds the product and the sum separately (the kernel rounds once).

The JAX module's ``step_flops`` read XLA's cost model, which has no
counterpart here: the port counts the operations of its kernels by hand
(``chip_smoke.py``).

    python -m mujoco_maze_tpu_torch.utils.roofline

prints the measured peak beside the data sheet's.
"""

from __future__ import annotations

import functools

import torch

from .._device import DeviceLike, resolve_device
from ..ops.lane_env import LAUNCHES

# Published fp32 rate of the H100 SXM outside the tensor cores (NVIDIA's
# data sheet, at the full 700 W power limit).
DATASHEET_FP32_FLOP_S = 67e12
# the chain's constants (those of the JAX package's peak kernel)
A, B = 1.000001, 1e-7


@functools.lru_cache(maxsize=None)
def _lib():
    import ctypes

    from ..ops import _build

    lib = _build.load()
    lib.mmt_fma_peak.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                 ctypes.c_void_p]
    lib.mmt_fma_peak.restype = ctypes.c_int
    return lib


def fma_chain_plain(x0: torch.Tensor, iters: int, a: float = A,
                    b: float = B) -> torch.Tensor:
    """``x = a x + b``, ``iters`` times, elementwise: the plain version."""
    x = x0
    for _ in range(iters):
        x = x * a + b
    return x


def fma_chain(x0: torch.Tensor, iters: int, a: float = A,
              b: float = B) -> torch.Tensor:
    """``x = fma(x, a, b)``, ``iters`` times, on a 1-D float32 tensor: the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if x0.dtype != torch.float32 or x0.dim() != 1 or not x0.is_contiguous():
        raise ValueError("x0 must be a contiguous 1-D float32 tensor")
    if x0.device.type == "cpu":
        return fma_chain_plain(x0, iters, a, b)
    if x0.device.type != "cuda":
        raise RuntimeError(f"no fma_peak kernel for device {x0.device}")
    out = torch.empty_like(x0)
    rc = _lib().mmt_fma_peak(x0.data_ptr(), out.data_ptr(), x0.numel(),
                             int(iters), a, b,
                             torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fma_peak launch failed with cudaError {rc}")
    LAUNCHES["fma_peak"] += 1
    return out


def fp32_peak_flops(n: int = 132 * 2048 * 8, iters: int = 4096,
                    launches: int = 10, reps: int = 5,
                    device: DeviceLike = None) -> float:
    """Measured fp32 FLOP/s of the card: ``launches`` back-to-back kernel
    launches on ``n`` chains of ``iters`` fused multiply-adds, timed with
    CUDA events after a warm-up, best of ``reps``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the fp32 peak is measured on the card")
    x = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    fma_chain(x, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = 0.0
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(launches):
            fma_chain(x, iters)
        end.record()
        torch.cuda.synchronize(dev)
        seconds = start.elapsed_time(end) * 1e-3
        best = max(best, 2.0 * n * iters * launches / seconds)
    return best


if __name__ == "__main__":
    peak = fp32_peak_flops()
    print(f"{torch.cuda.get_device_name(0)}: measured fp32 peak {peak:.6g} "
          f"FLOP/s, data sheet {DATASHEET_FP32_FLOP_S:.6g} "
          f"({peak / DATASHEET_FP32_FLOP_S:.4g} of it)")
