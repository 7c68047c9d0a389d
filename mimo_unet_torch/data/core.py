"""Host data pipeline: numpy datasets, epoch batches, and a prefetcher that
feeds the card.

Counterpart of ``mimo_unet_tpu/data/core.py`` (:29-129, :278, :490-526),
copied: the port imports nothing of the JAX package.  Datasets are dicts
of numpy arrays sharing the leading dimension (``ArrayDataset``);
per-epoch shuffling is one permutation from ``numpy.random.default_rng(
seed + epoch)``, so the port draws the JAX package's batches, and a batch
is one fancy-index slice (the JAX package's native multithreaded gather,
``data/_native``, is ROADMAP A.3; numpy's gather gives the same rows).

``prefetch_to_device`` overlaps the host's batch assembly and the copy to
the card with the step: a thread assembles the numpy batches; the
consumer copies each into a pinned host buffer and issues its copy to the
card on a side CUDA stream, one batch ahead of the one it hands out.
The device-resident datasets (``DeviceDataset``, ``PartialDeviceDataset``)
are ROADMAP A.3.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mimo_unet_torch.models.mimo_unet import resolve_device

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
    """Host-side size of a dataset's arrays."""
    return sum(v.nbytes for v in dataset.data.values() if v is not None)


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
