"""The exact relaxation of a small pyramid level: the CUDA kernel
``ops.kernels.exact_level`` and its plain version ``exact_level_plain``,
and the gate in ``models.pixflow._level_core`` that picks between them.

The CPU tests hold the routing, the wrapper's checks and counter, and the
plain version against the benchmark's frozen plain reference.  The card
tests (they skip without CUDA) hold the kernel to the plain version run on
the card, every byte equal, and whole stitches with the kernel to the same
stitches with the gate forced to the plain loop.  This file imports no
JAX, so on the machine with the card it runs as

    python -m pytest --noconftest tests/test_torch_exact_level.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            flow_params_by_name,
                                            synthesize_fisheye_set,
                                            synthesize_four_input_set)
from panorama_opticalflow_tpu_torch.models import pipeline
from panorama_opticalflow_tpu_torch.models import pixflow as pf
from panorama_opticalflow_tpu_torch.ops import kernels as tk
from panorama_opticalflow_tpu_torch.utils import programs, runtime

runtime.settle_cpu_math()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs these "
                    "checks at the cells' coarsest shapes)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _level_inputs(rng, b, h, w, flow_kind="zero", holes=False,
                  device="cpu"):
    """A level's planes as ``_level_core`` gets them: textured images,
    their blurred Sobel gradients (i1g the partner's), alphas (with holes
    that clear the update mask and a band of half alpha) and an incoming
    flow: zero, smooth and nonzero, or the search init's whole numbers."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for _ in range(b):
        ph = rng.random(3) * 6
        imgs.append(0.5 + 0.2 * np.sin(xx / 3.1 + ph[0])
                    * np.cos(yy / 4.3 + ph[1])
                    + 0.1 * np.sin((xx + yy) / 2.3 + ph[2])
                    + 0.05 * rng.standard_normal((h, w)))
    imgs = torch.from_numpy(np.stack(imgs).astype(np.float32)).to(device)
    alphas = np.ones((b, h, w), np.float32)
    if holes:
        alphas[:, :, :max(w // 5, 1)] = 0.0
        alphas[:, h // 3:h // 2, w // 2:w // 2 + 4] = 0.5
        alphas[1::2, :, w - w // 6:] = 0.0
    alphas = torch.from_numpy(alphas).to(device)
    params = flow_params_by_name("pixflow_low")
    gx, gy = pf._gradients(imgs, params)
    i1g = torch.stack([pf._partner(gx), pf._partner(gy)], dim=-1)
    if flow_kind == "zero":
        flow = np.zeros((b, h, w, 2), np.float32)
    elif flow_kind == "smooth":
        f = np.stack([2 * np.sin(yy / 7.0) + 1.5 * np.cos(xx / 5.0),
                      np.cos(yy / 6.0) - 0.5 * np.sin(xx / 9.0)], -1)
        flow = np.stack([f] * b) + 0.1 * rng.standard_normal((b, h, w, 2))
    else:
        flow = rng.integers(-5, 6, (b, h, w, 2))
    flow = torch.from_numpy(flow.astype(np.float32)).to(device)
    return (gx.contiguous(), gy.contiguous(), i1g.contiguous(),
            alphas.contiguous(), pf._partner(alphas).contiguous(), flow,
            params)


# ---------------------------------------------------------------------------
# CPU: the gate, the wrapper's checks and counter, the plain version
# ---------------------------------------------------------------------------


def _route(monkeypatch, shape, params, coarsest=True):
    """Which of the two exact forms ``_level_core`` calls for planes of
    ``shape``: both are replaced by recorders."""
    calls = []
    for name in ("exact_level", "exact_level_plain"):
        monkeypatch.setattr(tk, name, lambda *a, name=name: calls.append(
            (name, a[-2:])) or a[5])
    planes = torch.zeros(shape)
    pf._level_core(planes, planes, torch.zeros(shape + (2,)), planes,
                   planes, torch.zeros(shape + (2,)), params, coarsest)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("shape,expect", [
    ((2, 30, 27), "exact_level"),
    ((8, 27, 67), "exact_level"),
    ((2, 64, 64), "exact_level"),
    ((2, 45, 91), "exact_level"),
    ((2, 65, 64), "exact_level_plain"),
    ((2, 41, 100), "exact_level_plain")])
def test_level_core_routes_exact_levels_by_size(monkeypatch, shape, expect):
    """An exact level of at most EXACT_LEVEL_MAX_PIXELS goes to the kernel's
    wrapper with the coarsest schedule, a larger one to the plain loop."""
    params = flow_params_by_name("pixflow_low")
    assert tk.EXACT_LEVEL_MAX_PIXELS == 4096
    assert _route(monkeypatch, shape, params) == (expect, (4, 15))


def test_level_core_routes_every_exact_level(monkeypatch):
    """A relax_impl="exact" level that is not the coarsest takes the same
    gate with the refining schedule; the _fast presets' single coarsest
    phase too."""
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 relax_impl="exact")
    assert _route(monkeypatch, (2, 30, 40), params, coarsest=False) == \
        ("exact_level", (1, 3))
    fast = flow_params_by_name("pixflow_low_fast")
    assert _route(monkeypatch, (2, 25, 31), fast) == ("exact_level", (1, 15))


def test_use_pallas_false_keeps_the_plain_exact_loop(monkeypatch):
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 use_pallas=False)
    assert _route(monkeypatch, (2, 30, 27), params)[0] == \
        "exact_level_plain"


def test_exact_level_wrapper_checks_its_inputs(rng):
    i0x, i0y, i1g, a0, a1, flow, params = _level_inputs(rng, 2, 12, 14)
    args = [i0x, i0y, i1g, a0, a1, flow]

    def call(k=None, value=None, phases=1, iters=1):
        a = list(args)
        if k is not None:
            a[k] = value
        return tk.exact_level(*a, params, phases, iters)

    with pytest.raises(TypeError):          # dtype
        call(0, i0x.double())
    with pytest.raises(ValueError):         # shape
        call(2, i1g[..., :1].contiguous())
    with pytest.raises(ValueError):         # shape
        call(5, flow[:1])
    with pytest.raises(ValueError):         # devices mixed
        call(3, torch.empty_like(a0, device="meta"))
    with pytest.raises(ValueError):         # not contiguous
        call(0, i0x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):         # (B, H, W) planes
        call(0, i0x[0])
    with pytest.raises(ValueError):
        call(phases=-1)
    with pytest.raises(ValueError):         # a plane a bilinear cell needs
        tk.exact_level(*(t[:, :1].contiguous() for t in args), params, 1, 1)


def test_reset_launch_counts_covers_exact_level():
    assert tk.exact_level in tk.KERNELS
    tk.exact_level.launches = 7
    tk.reset_launch_counts()
    assert tk.exact_level.launches == 0


def test_exact_level_on_cpu_is_the_plain_loop(rng):
    """On CPU tensors the wrapper returns its plain version's result and
    launches nothing."""
    tk.reset_launch_counts()
    inputs = _level_inputs(rng, 2, 20, 23, "smooth", True)
    got = tk.exact_level(*inputs, 2, 3)
    assert torch.equal(got, tk.exact_level_plain(*inputs, 2, 3))
    assert tk.exact_level.launches == 0


def test_exact_level_plain_equals_the_benchmark_reference(rng):
    """The plain loop, moved out of _level_core, gives the bits of the
    frozen plain reference's coarsest level at six's coarsest size."""
    from portbench.reference import pixflow as ref_pf
    from portbench.reference.config import StitchConfig as RefConfig

    i0x, i0y, i1g, a0, a1, flow, params = _level_inputs(
        rng, 2, 30, 27, "zero", True)
    got = tk.exact_level_plain(i0x, i0y, i1g, a0, a1, flow, params, 4, 15)
    ref = ref_pf._level_core(i0x, i0y, i1g, a0, a1, flow,
                             RefConfig(flow_alg="pixflow_low").flow_params,
                             True)
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the card: the kernel against the plain loop, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,flow_kind,holes,phases,iters", [
    ((2, 30, 27), "zero", False, 4, 15),        # six's coarsest level
    ((2, 27, 67), "zero", True, 4, 15),         # four's
    ((8, 27, 67), "zero", True, 4, 15),         # batch4's descent
    ((2, 27, 67), "smooth", True, 4, 15),       # an incoming flow
    ((2, 30, 27), "search", True, 4, 15),       # the search init
    ((2, 25, 31), "zero", True, 1, 15),         # the _fast floor twin
    ((2, 45, 91), "smooth", True, 4, 15),       # ragged, at the limit
    ((2, 64, 64), "search", False, 2, 5)])
def test_exact_level_kernel_equals_plain(rng, cuda, shape, flow_kind, holes,
                                         phases, iters):
    inputs = _level_inputs(rng, *shape, flow_kind, holes, cuda)
    n = tk.exact_level.launches
    got = tk.exact_level(*inputs, phases, iters)
    assert tk.exact_level.launches == n + 1
    torch.cuda.synchronize()
    ref = tk.exact_level_plain(*inputs, phases, iters)
    assert torch.equal(got, ref), (got != ref).float().mean().item()


def test_exact_level_kernel_refuses_a_plane_above_shared_memory(rng, cuda):
    inputs = _level_inputs(rng, 2, 100, 100, device=cuda)
    with pytest.raises(ValueError, match="this card takes at most"):
        tk.exact_level(*inputs, 1, 1)


def _kernel_and_plain(run, monkeypatch):
    """``run()`` as a program (its key's eager call, capture and replay, a
    later replay; the launches of the last), then eagerly with the gate
    forced to the plain loop."""
    programs.clear()
    run()
    run()
    tk.reset_launch_counts()
    replayed = run()
    launches = tk.exact_level.launches
    programs.clear()
    monkeypatch.setattr(tk, "EXACT_LEVEL_MAX_PIXELS", 0)
    with programs.disable():
        plain = run()
    assert tk.exact_level.launches == launches
    return replayed, plain, launches


@pytest.mark.parametrize("what", ["chain", "stitch_four", "stitch_pairs"])
def test_stitches_with_the_kernel_equal_the_plain_loop(cuda, monkeypatch,
                                                       what):
    """A 6-photo chain (5 pairs), a four-input stitch (1 pair) and a
    batched descent of two pairs (one level of 4 directions) at 96 x 320:
    the replay with the kernel gives every byte of the stitch with the
    plain exact loop, and the kernel runs once a coarsest level."""
    cfg = StitchConfig(flow_alg="pixflow_low")
    four = synthesize_four_input_set(96, 320, seed=1)
    if what == "chain":
        photos, top = synthesize_fisheye_set(96, 320, n=5, seed=7)
        run, once = (lambda: pipeline.stitch_six(photos, top, cfg,
                                                 device=cuda)), 5
    elif what == "stitch_four":
        run, once = (lambda: pipeline.stitch_four(four, cfg,
                                                  device=cuda)), 1
    else:
        stack = np.stack(four[:2])
        run, once = (lambda: pipeline.stitch_pairs(
            stack, stack[::-1].copy(), cfg, device=cuda)), 1
    replayed, plain, launches = _kernel_and_plain(run, monkeypatch)
    assert launches == once
    assert torch.equal(replayed, plain)
    programs.clear()
