"""PyTorch / CUDA port of the panorama optical-flow stitcher.

The JAX package ``panorama_opticalflow_tpu`` is the reference; this
package mirrors its module names (``ops.image``, ``models.pixflow``, ...)
and is held against it on identical inputs by ``tests/test_torch_*.py``.

It imports ``torch`` and never ``jax``, and nothing of the JAX package.
Public functions keep the reference's
layouts: (H, W, 4) uint8 RGBA canvases, (H, W, 2) float32 flows as
(fx, fy), and channel-split (2B, H, W) planes inside the solver.

The five Pallas kernels of the reference are hand-written CUDA kernels
here (``csrc/``, wrapped by ``ops.kernels``).  For the port, the
``FlowParams`` fields ``use_pallas``, ``warp_pallas``, ``pallas_min_pixels``
and ``fuse_level_blurs`` mean "use the hand-written kernels"; a wrapper
runs its plain PyTorch version only for tensors that live on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from panorama_opticalflow_tpu_torch.utils.config import (  # noqa: F401
    FlowParams,
    StitchConfig,
    flow_params_by_name,
)
from panorama_opticalflow_tpu_torch.utils.data import (  # noqa: F401
    endpoint_error,
    ssim,
    synthesize_fisheye_set,
    synthesize_four_input_set,
)

__version__ = "0.1.0"


def to_torch(arr, device) -> torch.Tensor:
    """numpy (or array-like) -> tensor on ``device``, same dtype/layout."""
    a = np.require(np.asarray(arr), requirements=["C", "W"])
    return torch.from_numpy(a).to(device)


def _as_canvas(img, device) -> torch.Tensor:
    """A uint8 canvas or stack of canvases, array or tensor, on ``device``
    (a tensor keeps its dtype)."""
    if isinstance(img, torch.Tensor):
        return img.to(device)
    return to_torch(np.asarray(img, np.uint8), device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host, same dtype/layout."""
    return t.detach().cpu().numpy()
