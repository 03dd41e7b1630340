"""Configuration of the pixflow solver and the stitch pipeline.

The same frozen dataclasses as the JAX package's ``utils/config.py``,
restricted to the fields the port reads: the hyperparameter presets of
the reference factory ``makeOpticalFlowByName`` (CPU/PixFlow.hpp:459-500),
the solver constants (CPU/PixFlow.hpp:32-44) and the schedule knobs of
the fast path.  The JAX package's compile-time knobs (``pallas_bucket``,
``pallas_tile``, the ``scan_*`` rung scan and ``median_blur_size``, fixed
at 5 there too) have no meaning here and are left out.  The port keeps
its own copy so that nothing of the JAX package is imported on the card;
``tests/test_torch_no_jax.py`` holds every shared field and preset equal
to the JAX package's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlowParams:
    """Hyperparameters of the pixflow dense optical-flow solver."""

    # Factory presets (CPU/PixFlow.hpp:461-496)
    pyr_scale_factor: float = 0.9
    smoothness_coef: float = 0.001
    vertical_regularization_coef: float = 0.01
    horizontal_regularization_coef: float = 0.01
    gradient_step_size: float = 0.5
    downscale_factor: float = 0.5
    max_percentage: int = 0

    # Solver constants (CPU/PixFlow.hpp:32-44)
    pyr_min_image_size: int = 24
    pyr_max_levels: int = 1000
    # Raised pyramid floor of the _fast presets (0 = pyr_min_image_size):
    # the levels below it are replaced by one init solve on a
    # pyr_min_image_size twin of the coarsest level (models/pixflow).
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

    # Relaxation schedule: ``relax_phases`` phases of
    # ``relax_iters_per_phase`` Jacobi iterations, a 5x5 median after
    # each phase (the reference GPU build's schedule,
    # GPU/PixFlow_GPU.cu:273-295); the coarsest level, started from zero
    # init, runs the longer coarsest_* schedule.
    relax_phases: int = 1
    relax_iters_per_phase: int = 3
    coarsest_relax_phases: int = 4
    coarsest_relax_iters_per_phase: int = 15

    # "fast": the gather-free warp-recentred hat-window path
    # (ops/relax_fast) on every level but the coarsest; "exact":
    # per-candidate bilinear gathers everywhere.
    relax_impl: str = "fast"
    # Hat-window half-width of the bounded-residual sampling.
    fast_window: int = 2
    # Reuse the accepted propagation candidate's sample as the descent
    # residual instead of re-sampling at the accepted flow.
    fold_descent_sample: bool = True
    # In the port use_pallas means "use the hand-written CUDA kernels"
    # (ops/kernels) on every refining level: at least pallas_min_pixels
    # the kernel levels' contract, below it the small_* kernels with the
    # plain branch's borders and bits; fused (one relax + one median and
    # diffusion) when fuse_level_blurs is set and relax_phases is 1, else
    # per phase; and the tiled warp when warp_pallas is set.  The branch
    # taken does not depend on the device: a wrapper runs its plain
    # PyTorch version for CPU tensors only.  use_pallas=False runs the
    # plain branch (the small kernels' plain versions) at every size.
    use_pallas: bool = True
    pallas_min_pixels: int = 128 * 512
    # Quantise the warped gradients to bfloat16 once at load; all
    # arithmetic stays float32.
    w1_bf16: bool = True
    fuse_level_blurs: bool = True
    warp_pallas: bool = True

    @property
    def search_distance(self) -> int:
        # radius of the coarsest-level search init (CPU/PixFlow.hpp:153-155)
        return (self.pyr_min_image_size * self.max_percentage + 50) // 100


def flow_params_by_name(name: str) -> FlowParams:
    """Flow-algorithm factory, parity with CPU/PixFlow.hpp:459-500 and the
    JAX package's ``_fast`` extensions (a 0.8-factor pyramid, a 64 px
    floor with an init-floor solve, one coarsest relax phase).  Modifiers:
    ``+stopN`` sets pyr_stop_size, ``+cphN`` coarsest_relax_phases, and
    ``+pairK`` is accepted and changes nothing: it pairs the reference's
    scan rungs, which the unrolled pyramid does not have."""
    base, sep, mod = name.partition("+")
    if base == "pixflow_low":
        p = FlowParams(max_percentage=0)
    elif base == "pixflow_search_20":
        p = FlowParams(max_percentage=20)
    elif base == "pixflow_low_fast":
        p = FlowParams(max_percentage=0, pyr_scale_factor=0.8,
                       pyr_stop_size=64, coarsest_relax_phases=1)
    elif base == "pixflow_search_20_fast":
        p = FlowParams(max_percentage=20, pyr_scale_factor=0.8,
                       pyr_stop_size=64, coarsest_relax_phases=1)
    else:
        raise ValueError(f"unrecognized flow algorithm name: {name}")
    if sep:
        if mod.startswith("pair") and mod[4:].isdigit():
            pass
        elif mod.startswith("stop") and mod[4:].isdigit():
            p = dataclasses.replace(p, pyr_stop_size=int(mod[4:]))
        elif mod.startswith("cph") and mod[3:].isdigit():
            p = dataclasses.replace(p, coarsest_relax_phases=int(mod[3:]))
        else:
            raise ValueError(f"unrecognized flow algorithm modifier: {mod}")
    return p


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """End-to-end stitch pipeline configuration.

    The flow inputs are wrap-extended by cols/20 on each side
    (CPU/OpticalFlow.cpp:113-126) and the blend map by cols/5
    (CPU/StitchTool.cpp:102-111) on the x-periodic canvas.
    """

    flow_alg: str = "pixflow_low"
    # Denominators of the wrap-extension widths (cols // N).
    flow_extend_div: int = 20
    blend_extend_div: int = 5
    # Blend-field constants (CPU/StitchTool.cpp:130-143,148-158)
    blend_step_div: int = 200          # ray stride = min(rows, cols)//200
    blend_smooth_kernel_div: int = 130  # selective box blur = rows//130
    blend_global_blur_div: int = 400    # final global box blur = rows//400
    # Gather hole-search radius (CPU/StitchTool.cpp:77)
    gather_search_radius: int = 100
    # Blend-field resolution divisor: the field is computed on an
    # s-decimated canvas map and bilinearly upsampled.  0 = auto: 2 for
    # the _fast presets, 1 (the reference-exact field) otherwise.
    blend_scale: int = 0

    @property
    def blend_scale_resolved(self) -> int:
        if self.blend_scale:
            return self.blend_scale
        return 2 if "_fast" in self.flow_alg else 1

    @property
    def flow_params(self) -> FlowParams:
        return flow_params_by_name(self.flow_alg)


def with_flow_params(cfg: StitchConfig, **changes) -> StitchConfig:
    """``cfg`` whose ``flow_params`` are its preset's with ``changes``
    applied (e.g. ``relax_phases=2, relax_iters_per_phase=2``): a schedule
    knob under the same preset name, as the JAX package's 36 MP fidelity
    harness (``tools/fidelity_36mp.py``) sets its knobs."""
    params = dataclasses.replace(cfg.flow_params, **changes)

    class Knobbed(type(cfg)):
        @property
        def flow_params(self) -> FlowParams:
            return params

    return Knobbed(**dataclasses.asdict(cfg))
