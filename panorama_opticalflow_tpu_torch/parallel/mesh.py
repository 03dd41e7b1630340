"""Row communicators for the row-tiled stitch (counterpart of the
reference's ``parallel/mesh.py``, which builds a 1-D device mesh).

The tiled stitch (``parallel.tiled``) holds a canvas as row tiles: a
tile-stacked tensor is ``(T, h_loc, ...)``, tile ``t`` of it the global
rows ``[g * h_loc, (g + 1) * h_loc)`` for ``g = tile_index()[t]``.  A
communicator moves rows between the tiles.  Two implementations:

* ``InProcessRows(n)``: all n tiles as one stack in one process (T = n);
  an exchange is slicing and concatenation on one device.  This is the
  form one GPU runs.
* ``DistributedRows()``: one tile a rank of ``torch.distributed`` (T = 1);
  an exchange is one send and one receive each way, a gather is
  ``all_gather``.  It runs under gloo on CPU tensors and under NCCL with
  one GPU a rank.

Both give a tile the same bits: every stage of the tiled stitch computes
each plane of a stack as it computes that plane alone.
"""

from __future__ import annotations

import datetime
import os

import torch


def _fill_rows(edge_rows: torch.Tensor, halo: int, fill,
               top: bool) -> torch.Tensor:
    """``halo`` rows beyond the global top (``top``) or bottom of a tile
    whose own rows are ``edge_rows`` (h, ...): reflect-101 or a constant."""
    if fill == "reflect":
        if top:
            return edge_rows[1:halo + 1].flip(0)
        return edge_rows[-halo - 1:-1].flip(0)
    return torch.full((halo,) + edge_rows.shape[1:], fill,
                      dtype=edge_rows.dtype, device=edge_rows.device)


def _extend_gathered(full: torch.Tensor, halo: int, fill) -> torch.Tensor:
    """The global rows ``full`` (n*h, ...) extended by ``halo`` rows each
    side: reflect-101 within one reflection, beyond it the edge-repeat of
    the reference (its top repeats the LAST row, its bottom the first), or
    a constant."""
    hg = full.shape[0]
    if fill == "reflect":
        r = min(halo, hg - 1)
        top = full[1:r + 1].flip(0)
        bot = full[-r - 1:-1].flip(0)
        if r < halo:
            top = torch.cat([full[-1:].expand((halo - r,) + full.shape[1:]),
                             top])
            bot = torch.cat([bot, full[:1].expand((halo - r,)
                                                  + full.shape[1:])])
    else:
        top = torch.full((halo,) + full.shape[1:], fill, dtype=full.dtype,
                         device=full.device)
        bot = top
    return torch.cat([top, full, bot])


class RowComm:
    """What the tiled stitch needs of a communicator; see the module
    docstring.  ``n`` is the global number of tiles."""

    n: int

    def tile_index(self) -> list[int]:
        """The global tile indices of this process's T tiles (consecutive
        in both communicators)."""
        raise NotImplementedError

    def tile_slice(self) -> slice:
        """``tile_index()`` as a slice of an (n, ...) stack: a view, with
        no index tensor sent to the device."""
        t = self.tile_index()
        return slice(t[0], t[-1] + 1)

    def all_gather_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """(T, ...) per-tile tensors of every process -> (n, ...), tile g
        at g."""
        raise NotImplementedError

    def exchange_rows(self, x: torch.Tensor, halo: int,
                      fill="reflect") -> torch.Tensor:
        """(T, h, ...) -> (T, h + 2*halo, ...): each tile with ``halo`` rows
        of its neighbours on either side, one send and one receive each
        way; at the global top and bottom reflect-101 (``fill="reflect"``)
        or the constant ``fill``.  When ``halo >= h`` the global rows are
        gathered and sliced instead (the reference's all-gather branch)."""
        if halo == 0:
            return x
        h = x.shape[1]
        if halo >= h:
            ext = _extend_gathered(self.all_gather_rows(x), halo, fill)
            windows = ext.unfold(0, h + 2 * halo, h).movedim(-1, 1)
            return windows[self.tile_slice()]
        above, below = self._neighbour_rows(x, halo)
        first, last = self.tile_index()[0] == 0, \
            self.tile_index()[-1] == self.n - 1
        if first:
            above[0] = _fill_rows(x[0], halo, fill, top=True)
        if last:
            below[-1] = _fill_rows(x[-1], halo, fill, top=False)
        return torch.cat([above, x, below], dim=1)

    def _neighbour_rows(self, x: torch.Tensor, halo: int):
        """(above, below), each (T, halo, ...): the last rows of the tile
        above each tile and the first rows of the tile below (anything at
        the global top and bottom, which the caller fills)."""
        raise NotImplementedError

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(T, h, ...) -> the global (n*h, ...) rows."""
        g = self.all_gather_tiles(x)
        return g.reshape((-1,) + g.shape[2:])

    def min_over_later(self, s: torch.Tensor) -> torch.Tensor:
        """(T, ...) summaries -> for each tile the elementwise min over the
        summaries of the tiles below it (+inf below the last)."""
        g = self.all_gather_tiles(s)
        suffix = torch.cummin(g.flip(0), dim=0).values.flip(0)
        later = torch.cat([suffix[1:], torch.full_like(g[:1], float("inf"))])
        return later[self.tile_slice()]

    def max_over_earlier(self, s: torch.Tensor) -> torch.Tensor:
        """(T, ...) summaries -> for each tile the elementwise max over the
        summaries of the tiles above it (-inf above the first)."""
        g = self.all_gather_tiles(s)
        prefix = torch.cummax(g, dim=0).values
        earlier = torch.cat([torch.full_like(g[:1], -float("inf")),
                             prefix[:-1]])
        return earlier[self.tile_slice()]


class InProcessRows(RowComm):
    """All n tiles of a canvas as one (n, h, ...) stack on one device."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = n

    def tile_index(self) -> list[int]:
        return list(range(self.n))

    def all_gather_tiles(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _neighbour_rows(self, x, halo):
        above = torch.cat([x[:1, :halo], x[:-1, -halo:]])
        below = torch.cat([x[1:, :halo], x[-1:, -halo:]])
        return above, below


class DistributedRows(RowComm):
    """One tile a rank of the default ``torch.distributed`` group.  Tensors
    live on the CPU under gloo and on the rank's GPU under NCCL."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistributedRows needs an initialised "
                               "torch.distributed group "
                               "(maybe_init_distributed)")
        self.n = dist.get_world_size()
        self.rank = dist.get_rank()

    def tile_index(self) -> list[int]:
        return [self.rank]

    def all_gather_tiles(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def _neighbour_rows(self, x, halo):
        import torch.distributed as dist

        up, down = self.rank - 1, self.rank + 1
        above = x[:, :halo].clone()
        below = x[:, -halo:].clone()
        ops = []
        if up >= 0:
            ops += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), up),
                    dist.P2POp(dist.irecv, above, up)]
        if down < self.n:
            ops += [dist.P2POp(dist.isend, x[:, -halo:].contiguous(), down),
                    dist.P2POp(dist.irecv, below, down)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return above, below


def maybe_init_distributed(timeout_s: float = 300.0) -> DistributedRows | None:
    """Join the ``torch.distributed`` group the standard variables describe
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) and return
    its communicator; None when they are not set.  The backend is NCCL,
    with rank r on GPU r, when this machine has at least two GPUs, else
    gloo."""
    import torch.distributed as dist

    if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    if not dist.is_initialized():
        nccl = torch.cuda.is_available() and torch.cuda.device_count() >= 2
        if nccl:
            torch.cuda.set_device(int(os.environ["RANK"])
                                  % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if nccl else "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    return DistributedRows()
