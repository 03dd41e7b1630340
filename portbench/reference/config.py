"""Solver and stitch settings of the reference: the presets of the
upstream factory ``makeOpticalFlowByName`` (CPU/PixFlow.hpp:459-500), its
solver constants (CPU/PixFlow.hpp:32-44) and the port's fast-path
schedule, as fixed values of the benchmark."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FlowParams:
    pyr_scale_factor: float = 0.9
    smoothness_coef: float = 0.001
    vertical_regularization_coef: float = 0.01
    horizontal_regularization_coef: float = 0.01
    gradient_step_size: float = 0.5
    downscale_factor: float = 0.5
    max_percentage: int = 0
    pyr_min_image_size: int = 24
    pyr_max_levels: int = 1000
    # raised pyramid floor of the _fast presets (0: pyr_min_image_size)
    pyr_stop_size: int = 0
    grad_epsilon: float = 0.001
    update_alpha_threshold: float = 0.9
    pre_blur_kernel_width: int = 5
    pre_blur_sigma: float = 0.25
    final_flow_blur_kernel_width: int = 3
    final_flow_blur_sigma: float = 1.0
    gradient_blur_kernel_width: int = 3
    gradient_blur_sigma: float = 0.5
    blurred_flow_kernel_width: int = 15
    blurred_flow_sigma: float = 8.0
    relax_phases: int = 1
    relax_iters_per_phase: int = 3
    coarsest_relax_phases: int = 4
    coarsest_relax_iters_per_phase: int = 15
    # hat-window half-width of the bounded-residual sampling
    fast_window: int = 2
    # levels of at least this many pixels follow the kernels' contracts
    kernel_min_pixels: int = 128 * 512
    # the warped gradients are held in bfloat16, the arithmetic is not
    w1_bf16: bool = True
    # single-phase kernel levels fuse the target blur, median and diffusion
    fuse_level_blurs: bool = True
    # the solver's working type
    dtype: torch.dtype = torch.float32

    @property
    def search_distance(self) -> int:
        return (self.pyr_min_image_size * self.max_percentage + 50) // 100


PRESETS = {
    "pixflow_low": {},
    "pixflow_search_20": {"max_percentage": 20},
    "pixflow_low_fast": {"pyr_scale_factor": 0.8, "pyr_stop_size": 64,
                         "coarsest_relax_phases": 1},
    "pixflow_search_20_fast": {"max_percentage": 20, "pyr_scale_factor": 0.8,
                               "pyr_stop_size": 64,
                               "coarsest_relax_phases": 1},
}


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    flow_alg: str = "pixflow_low"
    flow_extend_div: int = 20
    blend_extend_div: int = 5
    blend_step_div: int = 200
    blend_smooth_kernel_div: int = 130
    blend_global_blur_div: int = 400
    gather_search_radius: int = 100
    # 0: 2 for the _fast presets, else 1
    blend_scale: int = 0
    # the solver's working type, and the least level size at which it
    # follows the kernels' contracts
    dtype: torch.dtype = torch.float32
    kernel_min_pixels: int = 128 * 512

    @property
    def blend_scale_resolved(self) -> int:
        if self.blend_scale:
            return self.blend_scale
        return 2 if "_fast" in self.flow_alg else 1

    @property
    def flow_params(self) -> FlowParams:
        if self.flow_alg not in PRESETS:
            raise ValueError(f"unknown flow algorithm {self.flow_alg!r}")
        return FlowParams(dtype=self.dtype,
                          kernel_min_pixels=self.kernel_min_pixels,
                          **PRESETS[self.flow_alg])
