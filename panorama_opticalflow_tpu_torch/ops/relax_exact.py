"""The exact gather relaxation (port of the reference's exact branch of
``models/pixflow.py``, CPU/PixFlow.hpp:306-456): the error function with a
bilinear fetch per candidate, the Jacobi iteration, and the flow blurs of
a level (its blurred-flow target and the low-alpha diffusion).

Every op is an elementwise op, a gather, a fixed-order tap sum or a
selection, on one direction or on a leading batch of directions, each as
alone.  ``ops.kernels.exact_level_plain`` runs a whole level of it; the
CUDA kernel ``ops.kernels.exact_level`` does the same arithmetic in one
launch.
"""

from __future__ import annotations

import torch

from panorama_opticalflow_tpu_torch.ops import image as im
from panorama_opticalflow_tpu_torch.ops.warp import bilinear_extend
from panorama_opticalflow_tpu_torch.utils.config import FlowParams


def error_function(cand: torch.Tensor, i0x: torch.Tensor, i0y: torch.Tensor,
                   i1g: torch.Tensor, blurred_flow: torch.Tensor,
                   params: FlowParams) -> torch.Tensor:
    """errorFunction (CPU/PixFlow.hpp:427-456): ``cand`` and ``i1g`` are
    (H, W, 2), returns the (H, W) error; or all with a leading batch of
    directions."""
    h, w = cand.shape[-3:-1]
    xs = torch.arange(w, dtype=torch.float32, device=cand.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=cand.device)[:, None]
    g1 = bilinear_extend(i1g, xs + cand[..., 0], ys + cand[..., 1],
                         batched=cand.dim() == 4)
    dx = i0x - g1[..., 0]
    dy = i0y - g1[..., 1]
    data = torch.sqrt(dx * dx + dy * dy)
    fd = blurred_flow - cand
    smooth = torch.sqrt(fd[..., 0] * fd[..., 0] + fd[..., 1] * fd[..., 1])
    reg = (params.vertical_regularization_coef * torch.abs(cand[..., 1])
           + params.horizontal_regularization_coef
           * torch.abs(cand[..., 0])) / w
    return data + params.smoothness_coef * smooth + reg


def _shift_with_valid(arr: torch.Tensor, dy: int, dx: int):
    """out[..., y, x, :] = arr[..., y - dy, x - dx, :] of a flow, zero
    outside; plus the (H, W) validity map."""
    h, w = arr.shape[-3:-1]
    out = torch.zeros_like(arr)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0), :] = \
        arr[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0), :]
    yy = torch.arange(h, device=arr.device)[:, None]
    xx = torch.arange(w, device=arr.device)[None, :]
    valid = (yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w)
    return out, valid


def relax_iteration(flow, i0x, i0y, i1g, blurred_flow, update_mask,
                    params: FlowParams) -> torch.Tensor:
    """One Jacobi round: 4-neighbour propagation (strictly-better
    proposals, CPU/PixFlow.hpp:342-362) + one finite-difference descent
    step (CPU/PixFlow.hpp:364-386).  On one direction ((H, W, 2) flow,
    (H, W) planes) or on a leading batch of directions, each iterated
    exactly as alone: every op is a gather or elementwise."""
    def err(c):
        return error_function(c, i0x, i0y, i1g, blurred_flow, params)

    best_flow = flow
    best_err = err(flow)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        cand, valid = _shift_with_valid(flow, dy, dx)
        e = torch.where(valid, err(cand), float("inf"))
        take = e < best_err
        best_flow = torch.where(take[..., None], cand, best_flow)
        best_err = torch.where(take, e, best_err)

    eps = params.grad_epsilon
    zero = torch.zeros((), device=flow.device)
    epsv = torch.full((), eps, device=flow.device)
    ex = err(best_flow + torch.stack([epsv, zero]))
    ey = err(best_flow + torch.stack([zero, epsv]))
    grad = torch.stack([(ex - best_err) / eps, (ey - best_err) / eps], dim=-1)
    new = best_flow - params.gradient_step_size * grad
    return torch.where(update_mask[..., None], new, flow)


def _as_planes(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2) flow -> (2B, H, W) channel-split planes."""
    b, h, w, _ = f.shape
    return f.permute(0, 3, 1, 2).reshape(b * 2, h, w)


def _from_planes(p: torch.Tensor, b: int) -> torch.Tensor:
    _, h, w = p.shape
    return p.reshape(b, 2, h, w).permute(0, 2, 3, 1).contiguous()


def _blur_flow(flow: torch.Tensor, params: FlowParams) -> torch.Tensor:
    nb = flow.shape[0]
    return _from_planes(im.gaussian_blur(
        _as_planes(flow), params.blurred_flow_kernel_width,
        params.blurred_flow_sigma), nb)


def low_alpha_flow_diffusion(flow: torch.Tensor, alpha0: torch.Tensor,
                             alpha1: torch.Tensor,
                             params: FlowParams) -> torch.Tensor:
    """flow <- lerp(flow, gauss15x15sigma8(flow), 1 - a0*a1)
    (CPU/PixFlow.hpp:388-405) on an (H, W, 2) flow and (H, W) alphas, or
    on a leading batch of them; the blur runs on channel-split planes."""
    blurred = _blur_flow(flow.reshape((-1,) + flow.shape[-3:]),
                         params).reshape(flow.shape)
    c = (1.0 - alpha0 * alpha1)[..., None]
    return c * blurred + (1.0 - c) * flow
