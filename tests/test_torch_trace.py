"""The port's tracer (``utils/trace.py``) on the CPU.

* The span tree of a stitch: names, parents, order and call numbers for
  the 6-photo chain (``pixflow_low``, ``pixflow_low_fast`` with its
  init-floor twin as a stage, and both under the search init, a stage of
  its own: ``pixflow_search_20`` and ``_fast``) and the full-canvas pass
  of N pairs, the flow's levels grouped by ``pallas_min_pixels``; and the
  leaf tiling: every
  operation of a body (views aside, which launch nothing) runs inside
  one of its ``pair.*`` stage spans, none of which holds another.
* With no recording open a body dispatches exactly the ops it dispatches
  without the tracer, and gives the same bytes; recording changes no
  byte and adds only the profiler's own range ops.
* A program's capture keeps its stage boundaries in capture order, and a
  recorded replay's times are read from them (a stand-in for the graph
  and its events, as ``tests/test_torch_programs.py`` stands in for it);
  the ``program.*`` spans of a key's eager call, capture and replays.
* The host-sync counter of the window plans.
"""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from panorama_opticalflow_tpu_torch import (StitchConfig,
                                            synthesize_fisheye_set,
                                            synthesize_four_input_set,
                                            to_torch)
from panorama_opticalflow_tpu_torch.models import crop, pipeline, pixflow
from panorama_opticalflow_tpu_torch.utils import programs, runtime, trace
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

torch.set_num_threads(2)
runtime.settle_cpu_math()

H, W = 96, 320
# the chain on a canvas whose planned windows are narrower than it (768
# of 1280 columns); on each canvas, the flow's levels straddle its
# pallas_min_pixels: plain levels and kernel levels (the kernels' plain
# versions, on the CPU) in one descent
CHAIN_HW, CHAIN_PMP = (64, 1280), 11000
PMP = 6000
# pixflow_low_fast's chain: 512-column windows of a 960-column canvas,
# whose flow's top level (66 x 164) lies above the raised floor, with an
# init-floor twin of four sizes below it and a plain and a kernel level
# above it
FAST_HW, FAST_PMP = (208, 960), 20000


def _cfg(pmp=PMP, flow_alg="pixflow_low"):
    return with_flow_params(StitchConfig(flow_alg=flow_alg),
                            pallas_min_pixels=pmp)


def _six(hw=(H, W)):
    photos, top = synthesize_fisheye_set(*hw, n=5, seed=7)
    return [to_torch(p, "cpu") for p in photos], to_torch(top, "cpu")


def _pairs(n=2):
    ls, rs = zip(*(pipeline.compose_four(
        [to_torch(p, "cpu") for p in synthesize_four_input_set(H, W,
                                                               seed=k)])
        for k in range(1, n + 1)))
    return torch.stack(ls), torch.stack(rs)


def _flow_spans(h, w, params):
    """The flow's spans of a pair whose flow input is h x w, in order:
    (name, args)."""
    sizes = pixflow.pyramid_sizes(int(h * params.downscale_factor),
                                  int(w * params.downscale_factor), params)
    top = len(sizes) - 1
    out = [("pair.flow_prep", None)]
    twin = pixflow._sub_floor_sizes(*sizes[top], params)
    assert bool(twin) == bool(params.pyr_stop_size)
    search = [("pair.flow_search_init", None)] if params.max_percentage \
        else []
    if twin:
        # the _fast presets' init-floor twin, a stage of its own; the
        # search init at its last size splits it in two stretches
        out.append(("pair.flow_floor_twin", None))
        out += [("flow.level", "%dx%d" % s) for s in twin]
        if search:
            out += search + [("pair.flow_floor_twin", None),
                             ("flow.level", "%dx%d" % twin[-1])]
    else:
        out += search
    out += [("pair.flow_coarsest", None),
            ("flow.level", "%dx%d" % sizes[top])]
    pmp = params.pallas_min_pixels
    plain = [s for s in sizes[top - 1::-1] if s[0] * s[1] < pmp]
    kernel = [s for s in sizes[top - 1::-1] if s[0] * s[1] >= pmp]
    assert plain and kernel
    for stage, group in (("pair.flow_plain_levels", plain),
                         ("pair.flow_kernel_levels", kernel)):
        out.append((stage, None))
        out += [("flow.level", "%dx%d" % s) for s in group]
    return out + [("pair.flow_prep", None)]


def _case(kind, pairs=5):
    """(root span, entry, body, tensors, static, the spans below the
    root: (name, args)); a chain of ``pairs`` pairs."""
    if kind.startswith("chain"):
        alg = ("pixflow_search_20" if "search" in kind
               else "pixflow_low") + ("_fast" if "fast" in kind else "")
        hw, pmp = ((FAST_HW, FAST_PMP) if "fast" in kind
                   else (CHAIN_HW, CHAIN_PMP))
        cfg = _cfg(pmp, alg)
        h, w = hw
        photos, top = _six(hw)
        photos = photos[:pairs]
        windows = crop.plan_chain_windows(photos, top, cfg)
        rolls = torch.tensor([r for r, _, _ in windows])
        shapes = tuple((wd, g) for _, wd, g in windows)
        expected = [("plan", None)]
        for _, width, _ in windows:
            # the window crop, then the flow on the window
            assert width < w
            expected += [("pair.blend", None), ("pair.flow_prep", None)]
            expected += _flow_spans(h, width, cfg.flow_params)
            expected += [("pair.novel_view", None), ("pair.composite", None)]
        return ("stitch.six",
                lambda: pipeline.stitch_six(photos, top, cfg, device="cpu"),
                pipeline._chain_body, (top, rolls, *photos), (shapes, cfg),
                expected)
    cfg = _cfg()
    ls, rs = _pairs()
    # the wrap-extension, then the flow on the extended canvas
    length = W // cfg.flow_extend_div
    expected = [("pair.blend", None), ("pair.flow_prep", None)]
    expected += _flow_spans(H, W + 2 * length, cfg.flow_params)
    expected += [("pair.novel_view", None), ("pair.composite", None)]
    return ("stitch.pairs",
            lambda: pipeline.stitch_pairs(ls, rs, cfg, device="cpu"),
            pipeline._stitch_pair_full_body, (ls, rs), (cfg,), expected)


class _Ops(TorchDispatchMode):
    """Counts the ops dispatched; with a recording, also the ops (views
    aside) that run inside no ``pair.*`` span, and those that run inside
    two."""

    def __init__(self, rec=None):
        super().__init__()
        self.rec = rec
        self.ops = collections.Counter()
        self.outside = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        if self.rec is not None and not func.is_view \
                and not str(func).startswith("profiler."):
            stages = [i for i in self.rec.open
                      if self.rec.spans[i].name.startswith("pair.")]
            if len(stages) != 1:
                self.outside[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["chain", "full N=2", "chain fast",
                                  "chain search", "chain search fast"])
def test_span_tree_and_leaf_tiling(kind):
    root, entry, body, tensors, static, expected = _case(kind)
    with trace.recording() as rec:
        entry()
    spans = rec.spans
    assert rec.calls == 1
    assert [(s.name, s.args) for s in spans] == [(root, None)] + expected
    assert all(s.call == 0 and s.end_ns >= s.start_ns for s in spans)
    assert spans[0].parent is None
    for s in spans[1:]:
        parent = spans[s.parent]
        if s.name == "flow.level":
            assert parent.name in ("pair.flow_floor_twin",
                                   "pair.flow_coarsest",
                                   "pair.flow_plain_levels",
                                   "pair.flow_kernel_levels")
            assert parent.start_ns <= s.start_ns <= s.end_ns <= \
                parent.end_ns
        else:
            assert s.parent == 0
    with trace.recording() as rec, _Ops(rec) as ops:
        body(*tensors, *static)
    assert sum(ops.ops.values()) > 1000
    assert ops.outside == {}
    assert rec.calls == sum(s.name.startswith("pair.") for s in rec.spans)


def test_recording_off_dispatches_the_ops_and_bytes_of_no_tracer(
        monkeypatch):
    _, _, body, tensors, static, _ = _case("full N=2")
    body(*tensors, *static)            # warm: fills the constant caches
    with _Ops() as off:
        out = body(*tensors, *static)
    with trace.recording(), _Ops() as on:
        recorded = body(*tensors, *static)
    monkeypatch.setattr(trace, "span", lambda *a, **k: trace._NULL)
    with _Ops() as bare:
        want = body(*tensors, *static)
    assert off.ops == bare.ops
    assert torch.equal(out, want) and torch.equal(recorded, want)
    profiler = {op for op in on.ops if op.startswith("profiler.")}
    assert profiler and {op: n for op, n in on.ops.items()
                         if op not in profiler} == bare.ops


class _Mark:
    """A stand-in for a timing event: its time is the count of marks
    made before it, in milliseconds."""

    made = 0

    def __init__(self):
        self.t = _Mark.made
        _Mark.made += 1

    def elapsed_time(self, other):
        return float(other.t - self.t)

    def synchronize(self):
        pass


class _Captured:
    """A stand-in for a captured program on the CPU: its construction
    runs the body once under ``trace.capturing`` (with ``_Mark``s for
    events), as a capture records event nodes, and each call runs the
    body again and hands the boundaries to the tracer, as a replay does."""

    def __init__(self, body, tensors, static, constants):
        self.body, self.static, self.constants = body, static, constants
        self.name = body.__qualname__
        with programs._reading(constants), \
                trace.capturing(_Mark) as self.boundaries:
            body(*tensors, *static)

    def __call__(self, tensors):
        trace.settle(self.boundaries)
        with programs._reading(self.constants):
            out = self.body(*tensors, *self.static)
        trace.replayed(self.name, self.boundaries)
        return out


@pytest.fixture
def captured(monkeypatch):
    monkeypatch.setattr(programs, "_captures",
                        lambda device: not programs._disabled)
    monkeypatch.setattr(programs, "_Program", _Captured)
    programs.clear()
    yield
    programs.clear()


def test_a_program_keeps_its_boundaries_in_capture_order(captured):
    _, entry, _, _, _, expected = _case("chain", pairs=2)
    stages = [name for name, _ in expected if name.startswith("pair.")]
    assert len(stages) == 2 * 9
    with trace.recording() as rec:
        first = entry()                    # the key's eager call
        assert programs.keys() == [] and not rec.pending
        second = entry()                   # capture, replay
        third = entry()                    # replay
    assert torch.equal(first, second) and torch.equal(first, third)
    (prog,) = programs._cache.values()
    assert [b[0] for b in prog.boundaries] == stages
    marks = [m.t for b in prog.boundaries for m in b[1:]]
    assert marks == sorted(marks) and len(set(marks)) == len(marks)
    # one replay read a call, at the next call's outermost span or when
    # the recording closed: each stretch one mark long, from the first
    assert [(r.program, r.call) for r in rec.replays] == \
        [("_chain_body", 1), ("_chain_body", 2)]
    for r in rec.replays:
        assert [name for name, _, _ in r.stages] == stages
        assert r.stages[0][1] == 0.0
        assert all(b - a == 1.0 for _, a, b in r.stages)
    got = rec.stage_ms()
    assert got == {name: float(stages.count(name)) for name in set(stages)}
    # the programs' spans: the eager call, then capture and replay, then
    # a replay, each under its call's root span
    progs = [(s.name, s.call, rec.spans[s.parent].name) for s in rec.spans
             if s.name.startswith("program.")]
    assert progs == [("program.eager", 0, "stitch.six"),
                     ("program.capture", 1, "stitch.six"),
                     ("program.replay", 1, "stitch.six"),
                     ("program.replay", 2, "stitch.six")]


def test_replays_are_read_before_the_same_programs_next_replay(captured):
    """Two replays of one program in one call (the chain's pairs without
    the chain program, use_crop=False: the full-canvas pair's program
    replayed a pair) are both read: the first before the second runs."""
    photos, top = _six()
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    for _ in range(2):
        pipeline.stitch_six(photos[:3], top, cfg, device="cpu",
                            use_crop=False)
    with trace.recording() as rec:
        pipeline.stitch_six(photos[:3], top, cfg, device="cpu",
                            use_crop=False)
    assert [(r.program, r.call) for r in rec.replays] == \
        [("_stitch_pair_full_body", 0)] * 3


def test_host_syncs_count_the_plans_reads():
    photos, top = _six()
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    with trace.recording() as rec:
        crop.plan_chain_windows(photos, top, cfg)
        crop.pair_window(torch.zeros((8, 16), dtype=torch.uint8), cfg)
    assert rec.host_syncs == 2
    crop.plan_chain_windows(photos, top, cfg)      # not recording
    assert rec.host_syncs == 2
    assert trace.span("x") is trace._NULL
    assert trace.span("x", stage=True) is trace._NULL
