"""The port's captured programs (``utils/programs.py``) on the CPU: what a
captured body may not do, the keys, the bound of the cache, and parity.

* Capture safety: after one warm run, a second run of each body records
  no host read (``aten._local_scalar_dense``, ``equal``, ``is_nonzero``),
  no copy of a host value (``aten.lift_fresh``) and no op whose output
  shape depends on the data, and calls neither ``torch.from_numpy`` nor
  ``Tensor.cpu``/``numpy``/``tolist``.  A CUDA graph holds none of them:
  each waits for the card or reads the host.
* Keys: one a change of config, window width or gather flag, shape, dtype
  or stack size, and for the tiled program of tiles or TileConfig; one for
  the same of everything else (a window's roll is an input, as the JAX
  package traces it).
* The cache: a key's first call is eager, its second captures; the bound
  evicts; a program holds the card-side constants its first call read.
* Parity: on the CPU a program is its body, so its bytes equal
  ``programs.disable()``'s (the tiled stitch's too; a ``DistributedRows``
  stitch never reaches ``programs.run``); the chain program against the JAX package's
  single-dispatch chain (``_chain_windowed_jit``) at the golden gate of
  tests/test_golden.py (alpha footprint exact, SSIM >= 0.995, < 1 % of
  values off by more than 8), at 96 x 320.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pipeline as jpl
from panorama_opticalflow_tpu.utils import config as jcfg
from panorama_opticalflow_tpu_torch import (StitchConfig, ssim,
                                            synthesize_fisheye_set,
                                            synthesize_four_input_set,
                                            to_numpy, to_torch)
from panorama_opticalflow_tpu_torch.models import crop, pipeline
from panorama_opticalflow_tpu_torch.parallel import mesh, tiled
from panorama_opticalflow_tpu_torch.utils import programs, runtime
from panorama_opticalflow_tpu_torch.utils.config import with_flow_params

torch.set_num_threads(2)
runtime.settle_cpu_math()

H, W = 96, 320
# ops a captured body may not run: host reads, host values copied in, and
# outputs whose shape depends on the data
FORBIDDEN = ("_local_scalar_dense", "aten.equal", "is_nonzero", "lift_fresh",
             "nonzero", "masked_select", "unique", "repeat_interleave.Tensor")


def _six(seed=7):
    photos, top = synthesize_fisheye_set(H, W, n=5, seed=seed)
    return [to_torch(p, "cpu") for p in photos], to_torch(top, "cpu")


def _roll(r):
    return torch.full((), r, dtype=torch.int64)


def _case(name):
    """(body, tensors, static) of one program at 96 x 320, as the entry
    points pass them (a window's roll a tensor)."""
    photos, top = _six()
    fast = StitchConfig(flow_alg="pixflow_low_fast")
    if name == "pair narrow window":
        # a window narrower than the canvas, hole search on it
        return pipeline._stitch_pair_windowed_body, \
            (photos[0], top, _roll(32)), (256, True, fast)
    if name.startswith("pair "):
        cfg = StitchConfig(flow_alg=name[5:])
        roll, *window = crop.plan_chain_windows(photos, top, cfg)[0]
        return pipeline._stitch_pair_windowed_body, \
            (photos[0], top, _roll(roll)), (*window, cfg)
    if name == "chain":
        windows = crop.plan_chain_windows(photos, top, fast)
        rolls = torch.tensor([r for r, _, _ in windows])
        return pipeline._chain_body, (top, rolls, *photos), \
            (tuple((wd, g) for _, wd, g in windows), fast)
    if name == "tiled 384x320 n=4":
        # tall enough that the finest flow levels run tiled
        il, ir = pipeline.compose_four([to_torch(p, "cpu") for p in
                                        synthesize_four_input_set(
                                            384, 320, seed=11)])
        return tiled._tiled_stitch_program_body, (il, ir), \
            (4, tiled.TileConfig(16, 32), None, False, StitchConfig())
    if name == "tiled window 128x640 n=4":
        # the 6-photo chain's second pair on its planned window
        photos, top = synthesize_fisheye_set(128, 640, n=5, seed=3)
        tp = [to_torch(p, "cpu") for p in photos]
        top = to_torch(top, "cpu")
        cfg = StitchConfig()
        wins = crop.plan_chain_windows(tp, top, cfg)
        r0 = pipeline.stitch_pair_auto(tp[0], top, cfg, window=wins[0],
                                       device="cpu")
        roll, width, gsafe = wins[1]
        assert width < 640
        return tiled._tiled_stitch_program_body, (tp[1], r0, _roll(roll)), \
            (4, tiled.TileConfig(8, 32), width, gsafe, cfg)
    if name.startswith("full N="):
        n = int(name[7:])
        return pipeline._stitch_pair_full_body, (
            torch.stack(photos[:n]) if n > 1 else photos[0],
            torch.stack([top] * n) if n > 1 else top), (fast,)
    assert name == "compose_four"
    four = [to_torch(p, "cpu") for p in synthesize_four_input_set(H, W,
                                                                  seed=1)]
    return pipeline.compose_four, (torch.stack(four),), ()


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", [
    "pair pixflow_low_fast", "pair pixflow_low", "pair pixflow_search_20_fast",
    "pair narrow window", "chain", "full N=1", "full N=2", "compose_four",
    "tiled 384x320 n=4", "tiled window 128x640 n=4"])
def test_body_is_capture_safe(name, monkeypatch):
    body, tensors, static = _case(name)
    body(*tensors, *static)   # warm: fills the device-side caches
    calls = collections.Counter()

    def counting(what, fn):
        def wrapped(*args, **kwargs):
            calls[what] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch, "from_numpy",
                        counting("from_numpy", torch.from_numpy))
    for method in ("cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, method,
                            counting(method, getattr(torch.Tensor, method)))
    with _Recorder() as rec:
        body(*tensors, *static)
    monkeypatch.undo()
    bad = {op: n for op, n in rec.ops.items()
           if any(f in op for f in FORBIDDEN)}
    assert sum(rec.ops.values()) > 0
    assert bad == {}, bad
    assert calls == {}, calls


def test_keys_change_with_every_static_value_and_nothing_else():
    photos, top = _six()
    l, r = photos[0], top
    fast = StitchConfig(flow_alg="pixflow_low_fast")
    pair = pipeline._stitch_pair_windowed_body
    base = programs.key(pair, (l, r, _roll(0)), (320, False, fast))
    changed = [
        programs.key(pair, (l, r, _roll(0)),
                     (320, False, StitchConfig(flow_alg="pixflow_low"))),
        programs.key(pair, (l, r, _roll(0)),
                     (320, False, with_flow_params(fast, relax_phases=2))),
        programs.key(pair, (l, r, _roll(0)), (256, False, fast)),
        programs.key(pair, (l, r, _roll(0)), (320, True, fast)),
        programs.key(pair, (l[:64], r[:64], _roll(0)), (320, False, fast)),
        programs.key(pair, (l.float(), r.float(), _roll(0)),
                     (320, False, fast)),
        programs.key(pipeline._stitch_pair_full_body, (l, r), (fast,)),
    ]
    full = pipeline._stitch_pair_full_body
    n1 = programs.key(full, (l[None], r[None]), (fast,))
    n2 = programs.key(full, (torch.stack([l, l]), torch.stack([r, r])),
                      (fast,))
    keys = [base, *changed, n1, n2]
    assert len(set(keys)) == len(keys)
    # other data, another roll (an input, as the reference traces it),
    # other tensor objects, other strides, an equal config
    same = [
        programs.key(pair, (photos[1], photos[2], _roll(0)),
                     (320, False, fast)),
        programs.key(pair, (l, r, _roll(32)), (320, False, fast)),
        programs.key(pair, (l.clone(), r.clone(), _roll(0)),
                     (320, False, StitchConfig(flow_alg="pixflow_low_fast"))),
        programs.key(pair, (l.transpose(0, 1).contiguous().transpose(0, 1),
                            r, _roll(0)), (320, False, fast)),
    ]
    assert all(k == base for k in same)
    windows = crop.plan_chain_windows(photos, top, fast)
    rolls = torch.tensor([ro for ro, _, _ in windows])
    shapes = tuple((wd, g) for _, wd, g in windows)
    chain = programs.key(pipeline._chain_body, (top, rolls, *photos),
                         (shapes, fast))
    assert chain == programs.key(pipeline._chain_body,
                                 (top, rolls + 32, *photos), (shapes, fast))
    other = ((256, True),) + shapes[1:]
    assert chain != programs.key(pipeline._chain_body, (top, rolls, *photos),
                                 (other, fast))
    assert chain != programs.key(pipeline._chain_body,
                                 (top, rolls[:4], *photos[:4]),
                                 (shapes[:4], fast))


def test_tiled_keys_change_with_every_static_value_and_nothing_else():
    """The tiled program's key: the static values of the reference's
    ``_tiled_stitch_jit`` with the mesh reduced to n (the global rows are
    the canvases' shape); not the roll, not the data."""
    l, r = (torch.zeros((96, 320, 4), dtype=torch.uint8) for _ in range(2))
    body = tiled._tiled_stitch_program_body
    tc = tiled.TileConfig(16, 32)
    fast = StitchConfig(flow_alg="pixflow_low_fast")
    win = (l, r, _roll(0))
    base = programs.key(body, win, (4, tc, 256, False, fast))
    changed = [
        programs.key(body, win, (8, tc, 256, False, fast)),
        programs.key(body, win, (4, tiled.TileConfig(8, 32), 256, False,
                                 fast)),
        programs.key(body, win, (4, tiled.TileConfig(16, 48), 256, False,
                                 fast)),
        programs.key(body, (l[:64], r[:64], _roll(0)),
                     (4, tc, 256, False, fast)),
        programs.key(body, win, (4, tc, 192, False, fast)),
        programs.key(body, win, (4, tc, 256, True, fast)),
        programs.key(body, win, (4, tc, 256, False, StitchConfig())),
        programs.key(body, (l, r), (4, tc, None, False, fast)),
    ]
    keys = [base, *changed]
    assert len(set(keys)) == len(keys)
    same = [programs.key(body, (l, r, _roll(32)), (4, tc, 256, False, fast)),
            programs.key(body, (l + 1, r + 2, _roll(0)),
                         (4, tiled.TileConfig(16, 32), 256, False,
                          StitchConfig(flow_alg="pixflow_low_fast")))]
    assert all(k == base for k in same)


class _Stand:
    """A stand-in for a captured program on the CPU (which has no
    graphs): it runs the body on call, under the constants its key's
    eager call read, as a capture reads them."""

    made: list = []

    def __init__(self, body, tensors, static, constants):
        _Stand.made.append(static)
        self.body, self.static, self.constants = body, static, constants

    def __call__(self, tensors):
        with programs._reading(self.constants):
            return self.body(*tensors, *self.static)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(programs, "_captures",
                        lambda device: not programs._disabled)
    monkeypatch.setattr(programs, "_Program", _Stand)
    _Stand.made = []
    programs.clear()
    yield _Stand.made
    programs.clear()


def test_cache_is_bounded_reused_and_cleared(stand_in):
    """The cache logic with a stand-in for the graph: a key's first call
    runs eagerly and makes no program, its second makes one, the least
    recently used program goes first, a cached key is replayed, ``clear()``
    empties the cache, and ``disable()`` bypasses it."""
    made = stand_in

    def body(x, k):
        return x + k

    x = torch.zeros(3)
    n = programs.MAX_PROGRAMS + 1
    for k in range(n):
        assert torch.equal(programs.run(body, (x,), k), x + k)
    assert made == [] and programs.keys() == []
    for k in range(n):
        assert torch.equal(programs.run(body, (x + 1,), k), x + 1 + k)
    assert made == [(k,) for k in range(n)]
    assert [key[-1] for key in programs.keys()] == \
        [(k,) for k in range(1, n)]
    programs.run(body, (x + 1,), 1)            # replayed, most recent now
    assert len(made) == n
    assert programs.keys()[-1][-1] == (1,)
    # the evicted key starts over: an eager call, then a program
    programs.run(body, (x,), 0)
    assert len(made) == n
    programs.run(body, (x,), 0)
    assert made[-1] == (0,) and len(made) == n + 1
    with programs.disable():
        assert torch.equal(programs.run(body, (x,), 99), x + 99)
        assert torch.equal(programs.run(body, (x,), 99), x + 99)
    assert len(made) == n + 1
    with pytest.raises(ValueError, match="one device"):
        programs.run(body, (x, x.to("meta")), 0)
    programs.clear()
    assert programs.keys() == [] and programs.info() == []
    programs.run(body, (x,), 2)
    assert len(made) == n + 1


def test_program_holds_the_constants_its_warm_run_read(stand_in):
    """A graph reads the card-side constants through raw pointers, so the
    program keeps each one its key's eager call read, and its capture
    reads those tensors, whatever the constant caches did in between."""
    from panorama_opticalflow_tpu_torch.ops import image as im
    from panorama_opticalflow_tpu_torch.models import pixflow

    body, tensors, static = _case("pair pixflow_search_20_fast")
    eager = programs.run(body, tensors, *static)
    (held,) = programs._seen.values()
    makers = {k[1] for k in held}
    assert {"_pad_index", "_resize_axis_taps",
            "_search_candidates"} <= makers
    first = dict(held)
    for maker in (im._pad_index, im._resize_axis_taps,
                  pixflow._search_candidates):
        maker.cache_clear()
    read = []
    real_reading = programs._reading

    def spying(constants):
        read.append(constants)
        return real_reading(constants)

    programs._reading = spying
    try:
        out = programs.run(body, tensors, *static)
    finally:
        programs._reading = real_reading
    assert torch.equal(out, eager)
    (prog,) = programs._cache.values()
    assert prog.constants is read[0]
    assert prog.constants.keys() == first.keys()
    assert all(prog.constants[k] is v for k, v in first.items())
    # nothing was made again: the caches stayed empty
    assert im._pad_index.cache_info().currsize == 0


def test_card_side_constants_are_held_by_programs():
    """Every cache of the port that makes a tensor on a device is a
    ``programs.device_constant`` (bounded, held by the programs that read
    it), never a bare ``functools.lru_cache``."""
    import functools
    import importlib
    import inspect
    import pathlib

    import panorama_opticalflow_tpu_torch as port

    root = pathlib.Path(port.__file__).parent
    bare, held = [], []
    for path in sorted(root.rglob("*.py")):
        if "lru_cache" not in path.read_text() and \
                "device_constant" not in path.read_text():
            continue
        name = ".".join((port.__name__,
                         *path.relative_to(root).with_suffix("").parts))
        m = importlib.import_module(name.removesuffix(".__init__"))
        for attr, fn in vars(m).items():
            if (getattr(fn, "__module__", None) != m.__name__
                    or not hasattr(fn, "cache_info")
                    or "device" not in inspect.signature(fn).parameters):
                continue
            if isinstance(fn, functools._lru_cache_wrapper):
                bare.append(f"{m.__name__}.{attr}")
            else:
                held.append(attr)
                assert fn.cache_info().maxsize == programs.CONSTANTS
    assert bare == []
    assert {"_pad_index", "_resize_axis_taps", "_search_candidates",
            "_plan_taps"} <= set(held)


def test_tiled_stitch_is_one_program_a_width(stand_in, tmp_path,
                                            monkeypatch):
    """In process, ``tiled_stitch_pair``'s first call of a key runs
    eagerly, its second makes the program, and two rolls of one width share
    it; every result equals the ``programs.disable()`` bytes.  A
    ``DistributedRows`` stitch (a gloo group of one rank) never reaches
    ``programs.run`` and equals the in-process bytes."""
    import torch.distributed as dist

    il, ir = pipeline.compose_four([to_torch(p, "cpu") for p in
                                    synthesize_four_input_set(96, 320,
                                                              seed=1)])
    cfg = StitchConfig()
    tc = tiled.TileConfig(8, 24)
    got = {}
    for roll in (32, 96, 32):
        out = tiled.tiled_stitch_pair(il, ir, cfg, 4, tc=tc,
                                      window=(roll, 256), device="cpu")
        assert roll not in got or torch.equal(out, got[roll])
        got[roll] = out
    assert stand_in == [(4, tc, 256, False, cfg)]
    assert len(programs.keys()) == 1
    with programs.disable():
        for roll, out in got.items():
            assert torch.equal(out, tiled.tiled_stitch_pair(
                il, ir, cfg, 4, tc=tc, window=(roll, 256), device="cpu"))
        in_process = tiled.tiled_stitch_pair(il, ir, cfg, 1, tc=tc,
                                             window=(32, 256, True),
                                             device="cpu")

    def refused(*args):
        raise AssertionError("a DistributedRows stitch reached programs.run")

    monkeypatch.setattr(programs, "run", refused)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        out = tiled.tiled_stitch_pair(il, ir, cfg, 1, mesh.DistributedRows(),
                                      tc, window=(32, 256, True),
                                      device="cpu")
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, in_process)


def test_programs_equal_disabled_bytes_on_cpu():
    photos, top = _six()
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    got = pipeline.stitch_six(photos, top, cfg, device="cpu")
    with programs.disable():
        eager = pipeline.stitch_six(photos, top, cfg, device="cpu")
    assert torch.equal(got, eager)
    parts = []
    by_part = pipeline.stitch_six(photos, top, cfg, device="cpu",
                                  on_part=lambda i, r: parts.append(i))
    assert parts == [1, 2, 3, 4, 5]
    assert torch.equal(by_part, got)
    ls = torch.stack(photos[:2])
    rs = torch.stack([top, photos[2]])
    pairs = pipeline.stitch_pairs(ls, rs, cfg, device="cpu")
    with programs.disable():
        assert torch.equal(pairs, pipeline.stitch_pairs(ls, rs, cfg,
                                                        device="cpu"))


def test_chain_program_matches_jax_chain():
    """stitch_six on the chain path (on_part=None) against the JAX
    package's single-dispatch chain on the same planned windows."""
    photos, top = synthesize_fisheye_set(H, W, n=5, seed=7)
    cfg = StitchConfig(flow_alg="pixflow_low")
    windows = crop.plan_chain_windows([to_torch(p, "cpu") for p in photos],
                                      to_torch(top, "cpu"), cfg)
    assert {wd for _, wd, _ in windows} == {W}
    ref = np.asarray(jpl._chain_windowed_jit(
        jnp.stack([jnp.asarray(p) for p in photos]), jnp.asarray(top),
        jnp.asarray([r for r, _, _ in windows], jnp.int32),
        jnp.asarray([g for _, _, g in windows], bool), W,
        jcfg.StitchConfig(flow_alg="pixflow_low")))
    out = to_numpy(pipeline.stitch_six(photos, top, cfg, device="cpu"))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out[..., 3], ref[..., 3])
    assert ssim(out, ref) >= 0.995
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 8).mean() < 0.01


@pytest.mark.parametrize("hw,tiny", [((64, 288), (26, 116)),
                                     ((79, 311), (29, 26)),
                                     ((2000, 1792), (25, 23))])
def test_floor_twin_scale_by_two_floats_is_the_tensor_product(hw, tiny):
    """The init-floor twin scales its flow by two Python floats where it
    multiplied by a two-element float32 tensor (a copy from the host): the
    same IEEE products, bit for bit."""
    (hh, ww), (th, tw) = hw, tiny
    up = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 40, 50, 2)).astype(np.float32) * 30)
    ref = up * torch.tensor([ww / tw, hh / th], dtype=torch.float32)
    got = torch.stack([up[..., 0] * (ww / tw), up[..., 1] * (hh / th)], -1)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
