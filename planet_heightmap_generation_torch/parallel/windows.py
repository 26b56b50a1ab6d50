"""Windows of a cells split: the explicit halo exchange of the port's mesh.

The JAX package splits every ``[NP]``-leading array over the ``cells``
axis with a ``NamedSharding`` and lets XLA insert the collectives: halo
permutes for the band shifts, all-gathers for the dynamic gathers, psums
for the reductions. The port's kernels run a whole loop in one launch over
a whole ``[NP]`` plane, so the split is written out here.

The NP padded cells (Fibonacci-spiral order) split into W contiguous chunks
``[lo, hi)`` (uneven where W does not divide NP). Shard c holds a *window*:

- the cyclic global range ``[lo - H, hi + H)`` (H = the largest |band
  offset|), the chunk at positions ``[H, H + hi - lo)``: every band
  neighbour of a chunk row lies inside it, so a band shift never wraps;
- then the *remainder slots*: the cells that the remainder edges of the
  chunk rows read and that lie outside that range, in ascending order;
- then dead rows up to a multiple of 4 cells (the kernels load planes as
  float4 words).

The window's own graph keeps the global band bits of the chunk rows and
the chunk rows' remainder edges in global edge order (so ``rem_add`` and
the kernels' CSR walk add in the jnp order), their neighbours pointing
into the window or the slots. Every other row (halo, slots, dead) has no
bands and no remainder row: it is *frozen*, so no loop changes it, and an
exchange copies the owners' chunk rows into the halo and slot rows of
every window (``index_copy_``, across devices where the owner lives on
another). A halo may span several shards when a chunk is shorter than H.

Every index map is built once per (mesh row, graph) with torch ops on the
edge list's device: nothing moves to the host but sizes.
"""

from __future__ import annotations

import dataclasses

import torch


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class WindowLayout:
    """The split of ``n_padded`` cells over one row of ``devices`` (a
    device may repeat) for the graph with bands ``band_off`` and the real
    remainder edges ``rem_src -> rem_dst`` (tensors on any one device).
    ``exchanges`` counts the exchanges run through it."""

    def __init__(self, devices, n_padded: int, band_off, rem_src=None,
                 rem_dst=None):
        self.devices = tuple(_norm_device(d) for d in devices)
        w = len(self.devices)
        npd = int(n_padded)
        if not 1 <= w <= npd:
            raise ValueError(f"cannot split {npd} cells over {w} devices")
        self.n_padded = npd
        self.band_off = tuple(int(o) for o in band_off)
        self.halo = h = max((abs(o) for o in self.band_off), default=0)
        self.bounds = tuple((c * npd // w, (c + 1) * npd // w)
                            for c in range(w))
        self.exchanges = 0
        if rem_src is None:
            rem_src = rem_dst = torch.zeros(0, dtype=torch.int64)
        src, dst = rem_src.long(), rem_dst.long()
        dev = src.device
        los = torch.tensor([lo for lo, _ in self.bounds], dtype=torch.int64,
                           device=dev)
        self._shards = []
        for lo, hi in self.bounds:
            n = hi - lo
            cyc = torch.remainder(
                torch.arange(lo - h, hi + h, dtype=torch.int64, device=dev),
                npd)
            where = torch.full((npd,), -1, dtype=torch.int64, device=dev)
            # the chunk's own position wins where the cyclic range laps
            where[cyc[h + n:]] = torch.arange(h + n, n + 2 * h, device=dev)
            where[cyc[:h]] = torch.arange(h, device=dev)
            where[cyc[h:h + n]] = torch.arange(h, h + n, device=dev)
            own = torch.nonzero((src >= lo) & (src < hi)).flatten()
            far = dst[own][where[dst[own]] < 0].unique()
            where[far] = n + 2 * h + torch.arange(far.numel(), device=dev)
            live = n + 2 * h + far.numel()
            length = -(-live // 4) * 4
            index = torch.cat([cyc, far, torch.full((length - live,), lo,
                                                    dtype=torch.int64,
                                                    device=dev)])
            # halo and slot positions, by the shard that owns their cell
            pos = torch.cat([torch.arange(h, device=dev),
                             torch.arange(h + n, live, device=dev)])
            owner = torch.searchsorted(los, index[pos], right=True) - 1
            chunk = torch.zeros(length, dtype=torch.bool, device=dev)
            chunk[h:h + n] = True
            shard = dict(lo=lo, hi=hi, length=length, index=index,
                         where=where.to(torch.int32), chunk=chunk, pulls=[],
                         src=h + src[own] - lo, dst=where[dst[own]])
            # pull k copies shard pulls[k]'s chunk rows at window positions
            # pull_src{k} to this window's positions pull_dst{k}
            for t in range(w):
                mine = owner == t
                if bool(mine.any()):
                    k = len(shard["pulls"])
                    shard["pulls"].append(t)
                    shard[f"pull_src{k}"] = h + index[pos[mine]] - los[t]
                    shard[f"pull_dst{k}"] = pos[mine]
            self._shards.append(shard)
        self._on = {}

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def _t(self, c: int, key: str, device=None):
        """Index map ``key`` of shard ``c`` on ``device`` (its own device
        by default), copied there once."""
        device = self.devices[c] if device is None else device
        k = (c, key, str(device))
        t = self._on.get(k)
        if t is None:
            t = self._shards[c][key].to(device)
            self._on[k] = t
        return t

    def length(self, c: int) -> int:
        return self._shards[c]["length"]

    def chunk_len(self, c: int) -> int:
        lo, hi = self.bounds[c]
        return hi - lo

    # ── windows of whole tensors, and back ───────────────────────────────

    def split(self, x, axis: int = 0) -> list:
        """The window of every shard of ``x`` along its cell ``axis``
        (halo and slots filled from ``x`` itself), each on its device."""
        return [x.index_select(axis, self._t(c, "index", x.device)).to(d)
                for c, d in enumerate(self.devices)]

    def chunk(self, win, c: int, axis: int = 0):
        """The chunk rows of shard ``c``'s window ``win`` (a view)."""
        return win.narrow(axis, self.halo, self.chunk_len(c))

    def gather(self, wins, axis: int = 0, device=None):
        """The whole tensor from the windows' chunks, in cell order, on
        ``device`` (the first shard's device by default)."""
        dev = self.devices[0] if device is None else _norm_device(device)
        return torch.cat([self.chunk(w, c, axis).to(dev)
                          for c, w in enumerate(wins)], dim=axis)

    def place(self, x, c: int):
        """Shard ``c``'s part of ``x``, a tensor or a tuple, named tuple,
        list or dict of them: every tensor with an ``[NP]`` leading axis as
        its window, every other tensor whole, on the shard's device; other
        values as they are."""
        if torch.is_tensor(x):
            if x.dim() >= 1 and x.shape[0] == self.n_padded:
                x = x.index_select(0, self._t(c, "index", x.device))
            return x.to(self.devices[c])
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(self.place(v, c) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(self.place(v, c) for v in x)
        if isinstance(x, dict):
            return {k: self.place(v, c) for k, v in x.items()}
        return x

    def gather_tree(self, parts, device=None):
        """The inverse of :meth:`place` over each shard's ``parts`` (one
        structure per shard): a tensor whose leading axis is every shard's
        window length is gathered from the chunk rows in cell order, any
        other value is shard 0's; tensors land on ``device`` (the first
        shard's by default)."""
        dev = self.devices[0] if device is None else _norm_device(device)
        first = parts[0]
        if torch.is_tensor(first):
            if first.dim() >= 1 and all(p.shape[0] == self.length(c)
                                        for c, p in enumerate(parts)):
                return self.gather(parts, 0, dev)
            return first.to(dev)
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return type(first)(*(self.gather_tree(list(z), dev)
                                 for z in zip(*parts)))
        if isinstance(first, (tuple, list)):
            return type(first)(self.gather_tree(list(z), dev)
                               for z in zip(*parts))
        if isinstance(first, dict):
            return {k: self.gather_tree([p[k] for p in parts], dev)
                    for k in first}
        return first

    def exchange(self, wins, axis: int = 0) -> None:
        """Copy the owners' chunk rows into every window's halo and slot
        rows, in place (chunk rows are read, never written)."""
        for c, win in enumerate(wins):
            for k, t in enumerate(self._shards[c]["pulls"]):
                rows = wins[t].index_select(
                    axis, self._t(c, f"pull_src{k}", wins[t].device))
                win.index_copy_(axis, self._t(c, f"pull_dst{k}", win.device),
                                rows.to(win.device))
        self.exchanges += 1

    # ── the windows' own graphs ──────────────────────────────────────────

    def band_mask(self, band_mask) -> list:
        """[L, D] window band masks: the chunk rows' global masks, no band
        on any other row."""
        return [m & self._t(c, "chunk")[:, None]
                for c, m in enumerate(self.split(band_mask))]

    def edges(self) -> list:
        """Per shard the chunk rows' remainder edges (``rem_src``,
        ``rem_dst``) as window positions, in global edge order."""
        return [(self._t(c, "src"), self._t(c, "dst"))
                for c in range(self.n_shards)]

    def graph(self, bits, band_off, rem_ptr, rem_nbr) -> "WindowGraph":
        """The window graph of one kernel call: ``bits`` [..., NP] int32
        band bits (the chunk rows' words, 0 elsewhere) and the chunk rows'
        slice of the remainder CSR ``rem_ptr`` [NP + 1] / ``rem_nbr`` [M]
        with window neighbours, and each window entry's global CSR index
        (``ent``, to window per-edge arrays such as stress's gates).
        Raises if a chunk row's remainder neighbour is outside its window
        and slots (a CSR of another graph than the layout's)."""
        if tuple(band_off) != self.band_off:
            raise ValueError("window graph: band offsets differ from the "
                             "layout's")
        shards = []
        for c, (lo, hi) in enumerate(self.bounds):
            d = self.devices[c]
            w = torch.where(self._t(c, "chunk", bits.device),
                            bits.index_select(
                                -1, self._t(c, "index", bits.device)), 0)
            a, b = int(rem_ptr[lo]), int(rem_ptr[hi])
            nbr = self._t(c, "where", rem_nbr.device)[rem_nbr[a:b].long()]
            if nbr.numel() and int(nbr.min()) < 0:
                raise ValueError(f"window graph: shard {c} has remainder "
                                 "neighbours outside its window and slots")
            n, h = hi - lo, self.halo
            dv = rem_ptr.device
            ptr = torch.cat([
                torch.zeros(h, dtype=torch.int32, device=dv),
                (rem_ptr[lo:hi + 1] - a).to(torch.int32),
                torch.full((self.length(c) - h - n,), b - a,
                           dtype=torch.int32, device=dv)])
            shards.append((w.to(d).contiguous(), ptr.to(d),
                           nbr.to(torch.int32).to(d).contiguous(),
                           torch.arange(a, b, device=dv).to(d)))
        return WindowGraph(self, self.band_off, tuple(shards))


    def window_graphs(self, g) -> list:
        """Per shard the :class:`~..mesh.device.DeviceGraph` of its window
        of the whole graph ``g`` (the layout's graph): positions and
        validity sliced to the window; band masks and bits on the chunk
        rows only; the chunk rows' remainder edges as window positions, in
        global edge order; the gather form ``nbr_idx`` / ``nbr_mask`` with
        window-local neighbours on the chunk rows and each other row
        pointing to itself, unmasked; ``n_cells`` the whole planet's. The
        stage functions run on it unchanged (parallel/spmd.py). Raises if a
        chunk row's neighbour lies outside its window and slots."""
        from ..mesh.device import DeviceGraph
        from ..ops.banded import pack_band_bits, rem_walk_edges

        if tuple(g.band_off) != self.band_off:
            raise ValueError("window graphs: band offsets differ from the "
                             "layout's")
        masks = self.band_mask(g.band_mask)
        out = []
        for c, d in enumerate(self.devices):
            idx = self._t(c, "index", g.device)
            chunk = self._t(c, "chunk", g.device)
            where = self._t(c, "where", g.device).long()
            local = where[g.nbr_idx.index_select(0, idx)]
            mask = g.nbr_mask.index_select(0, idx) & chunk[:, None]
            if bool((mask & (local < 0)).any()):
                raise ValueError(f"window graphs: shard {c} has neighbours "
                                 "outside its window and slots")
            own = torch.arange(idx.shape[0], device=g.device)[:, None]
            nbr = torch.where(chunk[:, None] & (local >= 0), local, own)
            src, dst = self._t(c, "src"), self._t(c, "dst")
            wg = DeviceGraph(
                pos=g.pos.index_select(0, idx).to(d).contiguous(),
                nbr_idx=nbr.to(d).contiguous(), nbr_mask=mask.to(d),
                valid=g.valid.index_select(0, idx).to(d),
                band_mask=masks[c], band_bits=pack_band_bits(masks[c]),
                rem_src=src, rem_dst=dst, n_cells=g.n_cells,
                band_off=self.band_off)
            rem_walk_edges(wg.rem_src, wg.rem_dst)
            out.append(wg)
        return out


@dataclasses.dataclass(frozen=True)
class WindowGraph:
    """One call's window graphs: per shard (bits, rem_ptr, rem_nbr, ent)."""

    layout: WindowLayout
    band_off: tuple
    shards: tuple

    def bits(self, c: int):
        return self.shards[c][0]

    def csr(self, c: int):
        return self.shards[c][1], self.shards[c][2]

    def edge_rows(self, per_edge, c: int):
        """The window entries of a global per-CSR-entry array [..., M]."""
        return per_edge.index_select(
            -1, self.shards[c][3].to(per_edge.device)).to(
                self.layout.devices[c]).contiguous()


@dataclasses.dataclass
class CellShards:
    """A value split over one row of a mesh: one window per shard
    (``windows[c]`` on ``layout.devices[c]``), ``axis`` its cell axis."""

    layout: WindowLayout
    windows: list
    axis: int = 0

    def gather(self, device=None):
        """The whole value, in cell order (chunk rows only)."""
        return self.layout.gather(self.windows, self.axis, device)


def split(layout: WindowLayout, x, axis: int = 0) -> CellShards:
    """``x`` split into ``layout``'s windows along its cell ``axis``."""
    return CellShards(layout, layout.split(x, axis), axis)

