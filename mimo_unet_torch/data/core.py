"""Data pipeline: numpy datasets, epoch batches, a prefetcher that feeds
the card, and the split pinned on the card.

Counterpart of ``mimo_unet_tpu/data/core.py`` (:29-129, :131-404,
:490-526), copied: the port imports nothing of the JAX package.  Datasets
are dicts of numpy arrays sharing the leading dimension
(``ArrayDataset``); per-epoch shuffling is one permutation from
``numpy.random.default_rng(seed + epoch)``, so the port draws the JAX
package's batches, and a batch is one row gather, done by the native
multithreaded gather (``data/_native``) where it serves, else by numpy.

``prefetch_to_device`` overlaps the host's batch assembly and the copy to
the card with the step: a thread assembles the numpy batches; the
consumer copies each into a pinned host buffer and issues its copy to the
card on a side CUDA stream, one batch ahead of the one it hands out.

``DeviceDataset`` puts a split on the card once (uint8 stays uint8) and
gathers a batch there with one ``index_select`` a key, so a step's host
work is drawing its rows.  ``PartialDeviceDataset`` pins what fits
(``device_cache_budget_bytes``) and streams the rest; its epoch stream is
the JAX package's, element for element, for the same seed and epoch.
Under a data mesh ``DeviceDataset(mesh=)`` pins each rank's shard of the
rows on its card and ``iterate_sharded_index_batches`` draws shard-local
rows, both as the JAX package does.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mimo_unet_torch.models.mimo_unet import resolve_device
from mimo_unet_torch.train.profiling import span

Batch = Dict[str, np.ndarray]


class ArrayDataset:
    """A dict of same-leading-dim numpy arrays with vectorized batch
    access."""

    def __init__(self, data: Dict[str, np.ndarray]):
        lens = {k: len(v) for k, v in data.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"mismatched leading dims: {lens}")
        self.data = data

    def __len__(self) -> int:
        return len(next(iter(self.data.values())))

    def __getitem__(self, index) -> Batch:
        """A 1-D index array gathers rows through the native gather where
        it serves (``data/_native``, which counts the path), else numpy."""
        if isinstance(index, np.ndarray) and index.ndim == 1:
            from mimo_unet_torch.data import _native

            out = {}
            for k, v in self.data.items():
                got = _native.gather_rows(v, index) if isinstance(v, np.ndarray) else None
                out[k] = got if got is not None else v[index]
            return out
        return {k: v[index] for k, v in self.data.items()}

    @property
    def keys(self):
        return self.data.keys()

    def map(self, fn: Callable[[str, np.ndarray], np.ndarray]) -> "ArrayDataset":
        return ArrayDataset({k: fn(k, v) for k, v in self.data.items()})


def iterate_batches(
    dataset: ArrayDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: Optional[int] = None,
    epoch: int = 0,
) -> Iterator[Batch]:
    """Yield batch dicts.  Shuffling reseeds per epoch (seed + epoch)."""
    for idx in iterate_index_batches(
        len(dataset), batch_size, shuffle=shuffle, drop_last=drop_last,
        seed=seed, epoch=epoch,
    ):
        yield dataset[idx]


def iterate_index_batches(
    n: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: Optional[int] = None,
    epoch: int = 0,
) -> Iterator[np.ndarray]:
    """Yield per-batch index arrays (the sampling half of
    ``iterate_batches``)."""
    if shuffle:
        rng = np.random.default_rng(None if seed is None else seed + epoch)
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        yield order[start : start + batch_size]


def dataset_nbytes(dataset: ArrayDataset) -> int:
    """Host-side size of a dataset's arrays (the device cache's capacity
    gate)."""
    return sum(v.nbytes for v in dataset.data.values() if v is not None)


class DeviceDataset:
    """A split pinned on ``device`` (the card when None) with an on-device
    batch gather.

    The arrays go to the device once, in their own dtype (uint8 stays
    uint8: an NYUv2 640x480 frame and its depth take 1.2288 MB), and
    ``gather(idx)`` is one ``index_select`` a key with the index on the
    device; ``device_normalize`` (``tasks/mimo.py``) then does the /255
    there.

    With ``mesh`` (a data mesh of more than one rank, ``parallel/mesh.py``)
    each rank pins only its shard of the rows on its card (``device``, or
    the mesh's), the JAX class's partition (mimo_unet_tpu/data/core.py
    :148-200): the wrapped index space [0, ceil(n/D)*D) is drawn once from
    ``seed`` (which rows are wrap-duplicated and which shard each lands
    in), shard d holds ``wrapped[d*n_local:(d+1)*n_local]``, and each
    epoch every shard permutes its fixed partition
    (``iterate_sharded_index_batches``).  ``nbytes`` is this rank's.
    """

    def __init__(self, dataset: ArrayDataset, device=None, mesh=None,
                 seed: int = 0):
        self.n = len(dataset)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        rows = slice(None)
        if self.mesh is None:
            self.n_shards = 1
            self.n_local = self.n
        else:
            d = self.mesh.size
            self.n_shards = d
            self.n_local = -(-self.n // d)  # ceil: wrapped pad to divisible
            rng = np.random.default_rng(seed)
            wrapped = rng.permutation(self.n)[np.arange(self.n_local * d) % self.n]
            rng.shuffle(wrapped)
            self.wrapped = wrapped
            rank = self.mesh.rank
            rows = wrapped[rank * self.n_local:(rank + 1) * self.n_local]
            if device is None:
                device = self.mesh.device
        self.device = resolve_device(device)
        self.data = {k: torch.as_tensor(np.ascontiguousarray(v[rows])).to(self.device)
                     for k, v in dataset.data.items() if v is not None}

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    def gather(self, idx) -> Dict[str, torch.Tensor]:
        """Rows ``idx`` (numpy or a tensor) -> dict of [B, ...] on the
        device.  Unsharded: ``idx`` [B] global rows.  Sharded: shard-local
        rows, this rank's [B/D] or the [D, B/D] of every rank
        (``iterate_sharded_index_batches``), whose row ``rank`` is taken."""
        with span("mimo.data.gather"):
            if self.mesh is not None and np.ndim(idx) == 2:
                idx = idx[self.mesh.rank]
            idx = torch.as_tensor(idx).to(self.device, non_blocking=True)
            return {k: v.index_select(0, idx) for k, v in self.data.items()}


def iterate_sharded_index_batches(
    n: int,
    n_shards: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: Optional[int] = None,
    epoch: int = 0,
) -> Iterator[np.ndarray]:
    """Shard-local sampling for a mesh-sharded DeviceDataset: yields
    [D, B/D] int32 arrays of shard-LOCAL rows.  Each shard permutes its
    FIXED partition per epoch (the partition was drawn once at
    DeviceDataset construction); batches are always full (drop_last on
    the per-shard remainder).  The JAX generator's output
    (mimo_unet_tpu/data/core.py:250-277), element for element."""
    assert batch_size % n_shards == 0, (batch_size, n_shards)
    bd = batch_size // n_shards
    n_local = -(-n // n_shards)
    rng = np.random.default_rng(None if seed is None else seed + epoch)
    if shuffle:
        orders = np.stack([rng.permutation(n_local) for _ in range(n_shards)])
    else:
        orders = np.tile(np.arange(n_local), (n_shards, 1))
    for start in range(0, (n_local // bd) * bd, bd):
        yield np.ascontiguousarray(
            orders[:, start:start + bd].astype(np.int32))


def device_cache_budget_bytes(device=None) -> Optional[int]:
    """Bytes the device cache may take: 60 % of the card's free memory
    (``torch.cuda.mem_get_info``), so that the model, its activations and
    the optimizer keep their headroom; None on the CPU, meaning no gate
    (as the JAX function's for backends without a memory limit)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(0.6 * free)


class PartialDeviceDataset:
    """The device cache past its budget: a fixed random subset of rows
    (chosen once with ``seed``) pinned on the device, the rest streamed
    from the host.

    Every row is visited once an epoch.  Pinned rows come as full
    on-device-gather batches, host rows as host batches, in a seeded
    interleaved order (reseeded per epoch); each batch is drawn from one
    stratum (cached or streamed) of the fixed partition, as in the JAX
    package (its docstring says how that differs from the uniform
    sampler).
    """

    def __init__(self, dataset: ArrayDataset, max_bytes: int, device=None,
                 seed: int = 0):
        self.dataset = dataset
        n = len(dataset)
        row_bytes = max(dataset_nbytes(dataset) / max(n, 1), 1)
        n_cache = min(n, int(max_bytes // row_bytes))
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        self.cached_rows = np.sort(perm[:n_cache])
        self.host_rows = perm[n_cache:]
        sub = ArrayDataset({
            k: np.ascontiguousarray(v[self.cached_rows])
            for k, v in dataset.data.items() if v is not None
        })
        self.cached = DeviceDataset(sub, device=device)

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def n_cached(self) -> int:
        return len(self.cached_rows)

    @property
    def nbytes(self) -> int:
        return self.cached.nbytes

    def epoch_batches(self, batch_size: int, *, seed: int = 0,
                      epoch: int = 0, shuffle: bool = True,
                      drop_last: bool = False):
        """Yield ("cached", local_idx [B] int32) / ("host", batch dict)
        items, the JAX function's stream (mimo_unet_tpu/data/core.py
        :358-404).

        Cached batches are always full ``batch_size``: the < B remainder
        of the cached stream goes through the host stream (its rows live
        on the host too, so none is dropped).  The host stream's ragged
        tail is yielded unless ``drop_last`` (the trainer passes True, as
        its host-fed path)."""
        rng = np.random.default_rng(None if seed is None else seed + epoch)
        nc = self.n_cached
        if shuffle:
            c_order = rng.permutation(nc)
            h_extra = self.cached_rows[c_order[(nc // batch_size)
                                               * batch_size:]]
            c_order = c_order[: (nc // batch_size) * batch_size]
            h_order = np.concatenate([self.host_rows, h_extra]).astype(
                np.int64)
            rng.shuffle(h_order)
        else:
            c_order = np.arange((nc // batch_size) * batch_size)
            h_extra = self.cached_rows[(nc // batch_size) * batch_size:]
            h_order = np.concatenate([self.host_rows, h_extra]).astype(
                np.int64)
        n_cb = len(c_order) // batch_size
        if drop_last:
            n_hb = len(h_order) // batch_size
        else:
            n_hb = -(-len(h_order) // batch_size) if len(h_order) else 0
        tags = np.array(["c"] * n_cb + ["h"] * n_hb)
        if shuffle:
            rng.shuffle(tags)
        ci = hi = 0
        for t in tags:
            if t == "c":
                yield ("cached",
                       c_order[ci * batch_size:(ci + 1) * batch_size]
                       .astype(np.int32))
                ci += 1
            else:
                rows = h_order[hi * batch_size:(hi + 1) * batch_size]
                yield ("host", self.dataset[rows])
                hi += 1


class DataModule:
    """Train/val/test split container mirroring the reference DataModule
    surface (setup + {train,val,test}_dataloader)."""

    batch_size: int

    def setup(self) -> None:
        raise NotImplementedError

    def train_dataset(self) -> ArrayDataset:
        raise NotImplementedError

    def val_dataset(self) -> Optional[ArrayDataset]:
        return None

    def test_dataset(self) -> Optional[ArrayDataset]:
        return None

    # dataloader-style iterators -------------------------------------------

    def train_batches(self, epoch: int, seed: int = 0) -> Iterator[Batch]:
        return iterate_batches(
            self.train_dataset(), self.batch_size,
            shuffle=True, drop_last=True, seed=seed, epoch=epoch,
        )

    def val_batches(self) -> Iterator[Batch]:
        ds = self.val_dataset()
        if ds is None:
            return iter(())
        return iterate_batches(ds, self.batch_size, drop_last=False)

    def test_batches(self) -> Iterator[Batch]:
        ds = self.test_dataset()
        if ds is None:
            return iter(())
        return iterate_batches(ds, self.batch_size, drop_last=False)


_END = object()


def _produce(iterator: Iterator[Batch], q: "queue.Queue",
             stop: threading.Event) -> None:
    """Drain ``iterator`` into ``q`` (None entries dropped), then _END; an
    exception goes to the consumer.  Gives up when ``stop`` is set."""
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for batch in iterator:
            if not put({k: v for k, v in batch.items() if v is not None}):
                return
    except Exception as e:  # noqa: BLE001 (handed to the consumer, raised there)
        put(e)
        return
    put(_END)


class _PinnedPool:
    """Pinned host buffers by (key, shape, dtype); a buffer is handed out
    again only once the copy that last read it has completed (its event)."""

    def __init__(self):
        self.free: Dict[Tuple, List[Tuple[torch.Tensor, torch.cuda.Event]]] = {}

    def take(self, key: str, array: np.ndarray) -> torch.Tensor:
        ring = self.free.setdefault((key, array.shape, array.dtype.str), [])
        for i, (buf, done) in enumerate(ring):
            if done.query():
                del ring[i]
                return buf
        return torch.empty(array.shape, dtype=torch.from_numpy(array[:0]).dtype,
                           pin_memory=True)

    def give(self, key: str, array: np.ndarray, buf: torch.Tensor,
             done: torch.cuda.Event) -> None:
        self.free[(key, array.shape, array.dtype.str)].append((buf, done))


def prefetch_to_device(
    iterator: Iterator[Batch],
    *,
    size: int = 2,
    device=None,
    chunk: int = 1,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Overlap host batch assembly and the copy to ``device`` (the card
    when None) with the consumer's work; yields dicts of tensors on
    ``device`` (None entries dropped).

    A background thread drains ``iterator`` (slicing, shuffling, copies)
    into a queue of ``size`` batches.  On the card the consumer copies
    each batch into a pinned host buffer and issues a ``non_blocking``
    copy to the card on a side stream, and only then hands out the batch
    before it, so that batch i + 1 travels while step i runs; the compute
    stream waits on the copy's event, and the device tensors are
    ``record_stream``-ed to it.
    A pinned buffer is reused only after its copy has completed.  On the
    CPU it is a thread-fed iterator of ``torch.from_numpy`` views.

    ``chunk`` > 1 (the JAX package's batched upload, a workaround for a
    remote-compile relay and a measured regression there) raises."""
    if chunk != 1:
        raise ValueError("prefetch_to_device uploads one batch at a time "
                         f"(chunk=1), got chunk={chunk}")
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    producer = threading.Thread(target=_produce, args=(iterator, q, stop),
                                name="prefetch_to_device", daemon=True)
    producer.start()

    def host_batches() -> Iterator[Batch]:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    try:
        if dev.type != "cuda":
            for host in host_batches():
                yield {k: torch.from_numpy(v) for k, v in host.items()}
            return
        yield from _to_card(host_batches(), dev)
    finally:
        stop.set()
        producer.join(timeout=10)


def _to_card(batches: Iterator[Batch], dev: torch.device
             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Pinned, side-stream copies of ``batches`` to ``dev``, one ahead."""
    side = torch.cuda.Stream(dev)
    pool = _PinnedPool()

    def issue(host: Batch):
        out = {}
        for k, v in host.items():
            buf = pool.take(k, v)
            buf.numpy()[...] = v
            with torch.cuda.stream(side):
                out[k] = buf.to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            pool.give(k, v, buf, done)
        return out, done

    ahead = None
    for host in batches:
        nxt = issue(host)
        if ahead is not None:
            yield _hand_out(*ahead, dev)
        ahead = nxt
    if ahead is not None:
        yield _hand_out(*ahead, dev)


def _hand_out(batch: Dict[str, torch.Tensor], copied: torch.cuda.Event,
              dev: torch.device) -> Dict[str, torch.Tensor]:
    """The compute stream waits for the batch's copy; its tensors are
    marked as used there, so the allocator does not reuse them early."""
    compute = torch.cuda.current_stream(dev)
    compute.wait_event(copied)
    for t in batch.values():
        t.record_stream(compute)
    return batch
