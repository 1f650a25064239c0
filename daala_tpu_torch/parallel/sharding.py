"""Arrays cut into tiles over a (dp, sp) mesh of torch devices: the
port's counterpart of `jax.sharding.NamedSharding(mesh, PartitionSpec(...))`
as daala_tpu uses it (parallel/mesh.py, __graft_entry__.py).

JAX shards a plane over the mesh and XLA inserts the collectives that
the lapped filters need across a cut.  Nothing inserts them here, so
the cuts and the halos are explicit:

- `Sharding(mesh, spec)`: `spec` names, per array axis, the mesh axis
  it is cut over ("dp": the rows of the mesh, "sp": its columns) or
  None; axes past the end of `spec` are not cut (JAX's rule).
- `put(array, sharding, halo, unit)` uploads a numpy array as a
  `ShardedPlane`: one `Tile` per part, each a tensor on its device.
  The last two axes are cut on multiples of `unit` pixels (a
  superblock: 64 >> dec), so every node and block of the codec's grids
  lies in one tile; a leading (batch) axis is cut per element.  Parts
  are as even as whole units allow, the first ones the larger: 1088
  rows over 2 are 9 + 8 superblocks (JAX splits evenly and lets XLA
  pad; the port's uneven tiles change only where the work runs).  A
  plane with fewer units than parts leaves the last devices without a
  tile.  `halo` more pixels are uploaded on each side of a tile that
  has a neighbour, the corners included: what a forward lapped filter
  needs, straight from the host plane.
- `ShardedPlane.exchange_halo(width)` gives each tile `width` pixels of
  its neighbours' interiors on each side that has one (corners
  included): what the inverse lapped filter needs, since its input is
  computed on the neighbours' devices.  Each copy waits on a CUDA event
  recorded on the producer's current stream, on the consumer's current
  stream; across cards it is a peer copy.  The bytes are counted in
  devstats' `halo_bytes`.
- `ShardedPlane.gather()` fetches the tiles to one numpy array, every
  tile's copy started before the first is waited for;
  `ShardedPlane.to(device)` assembles the plane on one device.
- `named_put(mesh, spec)` is the encoder's and decoder's placement
  hook, `device_put_fn(array, pli)`, with JAX's contract: it cuts a
  2-D or 3-D array as the spec says and puts a 1-D array whole on the
  mesh's first device (JAX replicates those).  The stages that gather
  over a whole plane (the PVQ search's flat coefficient buffer, the
  colour sweep's reference planes) run on that device.
- `stage_hook(device_put_fn, device)` is the hook a stage runs with:
  without one, the hook of the one-device mesh [device], which puts
  every plane as one tile with no halo.  So a stage has one path: its
  tiled one, which on one tile is the plane itself (the tile's origin
  is the plane's, its halo exchange copies nothing, and `to` and
  `gather` hand the tile's tensor over as it is).  `as_plane` does the
  same for a tensor.

Every device may appear in the mesh more than once: a 2 x 2 mesh on
one card (`make_mesh(devices=["cuda:0"] * 4, dp=2)`) runs four tiles on
it, and its halo copies are copies on that card.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from daala_tpu_torch.utils import devstats

SB = 64  # the luma superblock: the unit of every spatial cut
AXES = ("dp", "sp")


def split_units(n, parts):
    """Boundaries (parts + 1 of them) of n units cut into `parts` runs
    as even as whole units allow, the first ones the larger; runs past
    the n-th unit are empty."""
    base, extra = divmod(n, parts)
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


class Sharding:
    """A placement: `mesh` (a (dp, sp) array of torch.devices, as
    parallel/mesh.py make_mesh gives it, or one row of it) and `spec`,
    per array axis "dp", "sp" or None."""

    def __init__(self, mesh, spec):
        mesh = np.asarray(mesh, dtype=object)
        if mesh.ndim == 1:
            mesh = mesh.reshape(1, -1)
        if mesh.ndim != 2 or mesh.size == 0:
            raise ValueError("a mesh is a (dp, sp) array of devices")
        spec = tuple(spec)
        named = [a for a in spec if a is not None]
        if any(a not in AXES for a in named) or len(set(named)) < len(named):
            raise ValueError("a spec names 'dp', 'sp' or None per axis, "
                             "each mesh axis once; got %r" % (spec,))
        self.mesh = mesh
        self.spec = spec

    @property
    def device(self):
        """The mesh's first device: where replicated stages run."""
        return self.mesh[0, 0]

    def parts(self, ndim):
        """The number of parts of each of an ndim array's axes."""
        spec = self.spec + (None,) * (ndim - len(self.spec))
        if len(spec) > ndim:
            raise ValueError("spec %r for a %d-D array" % (self.spec, ndim))
        return tuple(1 if a is None else self.mesh.shape[AXES.index(a)]
                     for a in spec)

    def device_of(self, key):
        """The device of the tile with part indices `key`."""
        spec = self.spec + (None,) * (len(key) - len(self.spec))
        ij = [0, 0]
        for a, k in zip(spec, key):
            if a is not None:
                ij[AXES.index(a)] = k
        return self.mesh[ij[0], ij[1]]

    def bounds(self, n, axis_name):
        """split_units of n units over the mesh axis `axis_name`."""
        return split_units(n, 1 if axis_name is None
                           else self.mesh.shape[AXES.index(axis_name)])


def _units(unit):
    return (unit, unit) if isinstance(unit, int) else tuple(unit)


class Tile:
    """One part of a sharded array: `data`, a tensor on its device,
    holds the interior [start, stop) of every axis and `halo` =
    ((top, bottom), (left, right)) more of the last two axes; `key`
    is its part index per axis and `plane` the last two axes' full
    sizes."""

    __slots__ = ("data", "start", "stop", "halo", "key", "plane")

    def __init__(self, data, start, stop, halo, key, plane):
        self.data = data
        self.start = tuple(start)
        self.stop = tuple(stop)
        self.halo = tuple(tuple(h) for h in halo)
        self.key = tuple(key)
        self.plane = tuple(plane)

    @property
    def device(self):
        return self.data.device

    @property
    def origin(self):
        """The plane position of data's first row and column."""
        return (self.start[-2] - self.halo[0][0],
                self.start[-1] - self.halo[1][0])

    def crop(self, x=None):
        """The interior of `x` (default: data), a tensor laid out as data
        is, made contiguous when a halo is cut off."""
        x = self.data if x is None else x
        (ht, hb), (hl, hr) = self.halo
        if not (ht or hb or hl or hr):
            return x
        rows = self.stop[-2] - self.start[-2]
        cols = self.stop[-1] - self.start[-1]
        return x[..., ht:ht + rows, hl:hl + cols].contiguous()

    def slices(self):
        """The interior's place in the whole array (numpy slices)."""
        return tuple(slice(a, b) for a, b in zip(self.start, self.stop))


class ShardedPlane:
    """The tiles of a 2-D (or stacked 3-D) array of `shape` under
    `sharding`, in the order of their keys."""

    def __init__(self, shape, sharding, tiles):
        self.shape = tuple(shape)
        self.sharding = sharding
        self.tiles = list(tiles)

    @property
    def dtype(self):
        return self.tiles[0].data.dtype

    @property
    def device(self):
        return self.sharding.device

    def replace(self, datas):
        """A ShardedPlane with the same tiles holding `datas` (one tensor
        per tile, each its tile's interior, on its device), no halo."""
        return ShardedPlane(self.shape, self.sharding, [
            Tile(d, t.start, t.stop, ((0, 0), (0, 0)), t.key, t.plane)
            for t, d in zip(self.tiles, datas)])

    def frame(self, b):
        """Element b of a stacked 3-D array's leading axis, as a 2-D
        ShardedPlane of views of the tiles that hold it."""
        tiles = [Tile(t.data[b - t.start[0]], t.start[1:], t.stop[1:],
                      t.halo, t.key[1:], t.plane)
                 for t in self.tiles if t.start[0] <= b < t.stop[0]]
        return ShardedPlane(self.shape[1:], self.sharding, tiles)

    def stack(self, frames):
        """The 3-D ShardedPlane laid out as this one (its halo dropped)
        from `frames`, one 2-D ShardedPlane per element of the leading
        axis, each cut as frame(b) is."""
        datas = []
        for t in self.tiles:
            parts = []
            for b in range(t.start[0], t.stop[0]):
                (ft,) = [f for f in frames[b].tiles if f.key == t.key[1:]]
                parts.append(ft.data)
            datas.append(torch.stack(parts))
        return self.replace(datas)

    def gather(self, dtype=None):
        """The whole array as numpy (`dtype`: None keeps the tiles');
        every tile's copy is started before the first is waited for."""
        inner = [t.crop() for t in self.tiles]
        devstats.prefetch(*inner)
        parts = [devstats.fetch(x, dtype) for x in inner]
        if len(parts) == 1:
            return parts[0]
        out = np.empty(self.shape, parts[0].dtype)
        for t, a in zip(self.tiles, parts):
            out[t.slices()] = a
        return out

    def to(self, device):
        """The whole array as one tensor on `device`, assembled there from
        the tiles' interiors; a single tile already on `device` is
        returned as it is."""
        device = torch.device(device)
        if len(self.tiles) == 1 and self.tiles[0].device == device:
            return self.tiles[0].crop()
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for t in self.tiles:
            src = t.crop()
            if src.device != out.device:
                _order(src.device, out.device)
            out[t.slices()].copy_(src, non_blocking=True)
        return out

    def exchange_halo(self, width):
        """A ShardedPlane whose tiles hold their interiors and `width`
        more of their neighbours' on each side of the last two axes
        that has a neighbour, the corners included."""
        events = {}
        for t in self.tiles if len(self.tiles) > 1 else ():
            if t.device.type == "cuda" and t.device not in events:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                events[t.device] = ev
        out = []
        for t in self.tiles:
            (r0, c0), (r1, c1) = t.start[-2:], t.stop[-2:]
            ph, pw = self.shape[-2:]
            ht, hb = (width if r0 > 0 else 0), (width if r1 < ph else 0)
            hl, hr = (width if c0 > 0 else 0), (width if c1 < pw else 0)
            y0, x0 = r0 - ht, c0 - hl
            if not (ht or hb or hl or hr):
                out.append(Tile(t.crop(), t.start, t.stop, ((0, 0), (0, 0)),
                                t.key, t.plane))
                continue
            lead = tuple(b - a for a, b in zip(t.start[:-2], t.stop[:-2]))
            data = torch.empty(lead + (r1 - r0 + ht + hb, c1 - c0 + hl + hr),
                               dtype=t.data.dtype, device=t.device)
            data[..., ht:ht + r1 - r0, hl:hl + c1 - c0] = t.crop()
            nbytes = 0
            for s in self.tiles:
                if s is t or s.start[:-2] != t.start[:-2]:
                    continue
                (sr0, sc0), (sr1, sc1) = s.start[-2:], s.stop[-2:]
                ya, yb = max(sr0, y0), min(sr1, r1 + hb)
                xa, xb = max(sc0, x0), min(sc1, c1 + hr)
                if ya >= yb or xa >= xb:
                    continue
                if s.device.type == t.device.type == "cuda":
                    torch.cuda.current_stream(t.device).wait_event(
                        events[s.device])
                src = s.crop()[..., ya - sr0:yb - sr0, xa - sc0:xb - sc0]
                data[..., ya - y0:yb - y0, xa - x0:xb - x0].copy_(
                    src, non_blocking=True)
                nbytes += src.numel() * src.element_size()
            devstats.count("halo_bytes", nbytes)
            out.append(Tile(data, t.start, t.stop, ((ht, hb), (hl, hr)),
                            t.key, t.plane))
        return ShardedPlane(self.shape, self.sharding, out)


def _order(src, dst):
    """Make dst's current stream wait for the work queued so far on
    src's current stream (CUDA devices; nothing on the CPU)."""
    if src.type == "cuda" and dst.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(src))
        torch.cuda.current_stream(dst).wait_event(ev)


def put(array, sharding, halo=0, unit=SB):
    """Upload a numpy array as a ShardedPlane under `sharding`: the last
    two axes cut on multiples of `unit` (an int, or (rows, columns)),
    with `halo` more pixels on each side of a tile that has a
    neighbour; leading axes cut per element."""
    a = np.asarray(array)
    if a.ndim < 2:
        raise ValueError("put takes a 2-D or stacked 3-D array, got %s"
                         % (a.shape,))
    parts = sharding.parts(a.ndim)
    units = (1,) * (a.ndim - 2) + _units(unit)
    spec = sharding.spec + (None,) * (a.ndim - len(sharding.spec))
    bounds = []
    for size, u, name in zip(a.shape, units, spec):
        b = sharding.bounds(-(-size // u), name)
        bounds.append([min(x * u, size) for x in b])
    if a.ndim > 2 and any(a.shape[i] % parts[i] for i in range(a.ndim - 2)):
        raise ValueError("put: %s does not split over %s parts"
                         % (a.shape, parts))
    plane = a.shape[-2:]
    tiles = []
    for key in itertools.product(*(range(p) for p in parts)):
        start = [bounds[i][k] for i, k in enumerate(key)]
        stop = [bounds[i][k + 1] for i, k in enumerate(key)]
        if any(s >= e for s, e in zip(start, stop)):
            continue
        hl = []
        for i in (-2, -1):
            hl.append((halo if start[i] > 0 else 0,
                       halo if stop[i] < a.shape[i] else 0))
        sl = tuple(slice(s, e) for s, e in zip(start[:-2], stop[:-2])) + (
            slice(start[-2] - hl[0][0], stop[-2] + hl[0][1]),
            slice(start[-1] - hl[1][0], stop[-1] + hl[1][1]))
        data = devstats.upload(a[sl], sharding.device_of(key))
        tiles.append(Tile(data, start, stop, hl, key, plane))
    return ShardedPlane(a.shape, sharding, tiles)


class NamedPut:
    """device_put_fn(array, pli): the placement hook of the port's
    Encoder and Decoder (named_put)."""

    def __init__(self, mesh, spec):
        self.sharding = Sharding(mesh, spec)

    @property
    def device(self):
        return self.sharding.device

    def __call__(self, array, pli, *, halo=0, unit=SB):
        """A 2-D or 3-D array cut as the spec says (ShardedPlane, see
        put); a 1-D array whole on the first device.  pli is JAX's
        argument; `unit` is the plane's superblock."""
        a = np.asarray(array)
        if a.ndim == 1:
            return devstats.upload(a, self.device)
        return put(a, self.sharding, halo=halo, unit=unit)


def named_put(mesh, spec):
    """The placement hook for `mesh` (make_mesh's array, or one row of
    it) and `spec` (e.g. ("dp", "sp"): rows over dp, columns over sp)."""
    return NamedPut(mesh, spec)


def stage_hook(device_put_fn, device):
    """The placement hook a device stage runs with: `device_put_fn`,
    whose first device must be `device`, or for None the hook of the
    one-device mesh [device], whose planes are one tile each: the whole
    plane on `device`, with no halo."""
    if device_put_fn is None:
        return named_put([device], ("dp", "sp"))
    if device_put_fn.device != device:
        raise ValueError("device_put_fn places on %s, the stage runs on %s"
                         % (device_put_fn.device, device))
    return device_put_fn


def as_plane(x):
    """(plane, back): `x` as a ShardedPlane (a tensor becomes one tile on
    its device) and the function that gives a ShardedPlane laid out as
    `plane` back in x's form (a tensor for a tensor)."""
    if isinstance(x, ShardedPlane):
        return x, lambda p: p
    zero = (0,) * x.dim()
    plane = ShardedPlane(x.shape, Sharding([x.device], ()), [
        Tile(x, zero, x.shape, ((0, 0), (0, 0)), zero, x.shape[-2:])])
    return plane, lambda p: p.to(x.device)


def fetch_all(xs, dtype=torch.int32):
    """numpy copies of tensors and ShardedPlanes (devstats.fetch,
    ShardedPlane.gather), as `dtype` (None keeps theirs); every copy is
    started before the first is waited for."""
    devstats.prefetch(*[t.crop() for x in xs if isinstance(x, ShardedPlane)
                        for t in x.tiles if not any(map(any, t.halo))],
                      *[x for x in xs if isinstance(x, torch.Tensor)])
    return [x.gather(dtype) if isinstance(x, ShardedPlane)
            else devstats.fetch(x, dtype) for x in xs]
