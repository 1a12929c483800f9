"""Host-side data loader: shuffling, batching, per-process sharding,
background prefetch, and the device feed.

The port's copy of the JAX package's ``data/loader.py``, replacing the
reference's ``torch.utils.data.DataLoader`` usage (``data_utils/data.py:41-122``)
with a numpy loader:

* deterministic epoch shuffles from a seed (reproducible across hosts);
* ``shard=(rank, world_size)`` slices the index stream so each process
  loads only its own rows;
* ``transforms`` applied to the channel-concat of an item's image-like keys,
  so paired tensors get the same geometric draw;
* a background thread pipelines __getitem__/augmentation with device
  compute, and ``num_workers`` threads decode the items of a batch;
* ``state()``/``load_state()`` resume the data order;
* :func:`device_prefetch` copies batches onto the card ahead of use, from
  pinned host memory on a side CUDA stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from eo_diffusion_torch.data.datasets import Dataset

__all__ = ["DataLoader", "device_prefetch"]


class DataLoader:
    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        shard: Tuple[int, int] = (0, 1),
        transforms: Optional[Callable] = None,
        transform_keys: Tuple[str, ...] = ("image", "segmentation", "cond_image"),
        prefetch: int = 2,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.transforms = transforms
        self.transform_keys = transform_keys
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None
        self._epoch = 0

    # -- resumable iteration state (the loader-side half of fault tolerance;
    # the reference loses data-order state entirely on resume) -------------

    def state(self) -> dict:
        return {"epoch": self._epoch, "seed": self.seed}

    def load_state(self, state: dict) -> None:
        if state.get("seed", self.seed) != self.seed:
            raise ValueError("resuming a loader with a different shuffle seed")
        self._epoch = int(state["epoch"])

    def __len__(self) -> int:
        shard_id, n_shards = self.shard
        n = len(self.dataset) // n_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self._epoch).permutation(n)
        else:
            idx = np.arange(n)
        shard_id, n_shards = self.shard
        # trim every shard to the common floor(n / n_shards): the strided
        # slice alone hands low shards one extra item when n % n_shards != 0,
        # so processes would iterate DIFFERENT batch counts per epoch — a
        # deadlock under collectives that need every process in every
        # global batch, and a mismatch with __len__'s floor division
        return idx[shard_id::n_shards][: len(self.dataset) // n_shards]

    def _fetch_one(self, i: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        item = self.dataset[int(i)]
        if self.transforms is not None:
            # joint geometric transform over image|mask channel-concat
            # (reference data_load.py:295-297)
            keys = [k for k in self.transform_keys if k in item]
            chans = [item[k].shape[-1] for k in keys]
            joint = np.concatenate([item[k] for k in keys], axis=-1)
            joint = self.transforms(joint, rng)
            pos = 0
            item = dict(item)
            for k, c in zip(keys, chans):
                item[k] = np.ascontiguousarray(joint[..., pos : pos + c])
                pos += c
        return item

    def _make_batch(self, idxs: np.ndarray, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self.num_workers > 1:
            # race-safe per-item RNG: draw seeds sequentially (deterministic),
            # then decode/augment items in parallel (PIL/native extraction
            # release the GIL)
            from concurrent.futures import ThreadPoolExecutor

            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            seeds = rng.integers(0, 2**63, len(idxs))
            items = list(
                self._pool.map(
                    lambda args: self._fetch_one(args[0], np.random.default_rng(args[1])),
                    zip(idxs, seeds),
                )
            )
        else:
            items = [self._fetch_one(i, rng) for i in idxs]
        keys = items[0].keys()
        return {k: np.stack([it[k] for it in items]) for k in keys}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        self._epoch += 1
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        rng = np.random.default_rng((self.seed, self._epoch))

        if self.prefetch <= 0:
            for b in range(nb):
                yield self._make_batch(idx[b * self.batch_size : (b + 1) * self.batch_size], rng)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # timed put so an abandoned iteration (consumer breaks early,
            # generator finally sets `stop`) can't leave the worker blocked
            # forever on a full queue -- that leaked a thread + `prefetch`
            # buffered batches per epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    if not put(self._make_batch(idx[b * self.batch_size : (b + 1) * self.batch_size], rng)):
                        return
            except Exception as e:  # surface loader errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def device_prefetch(iterator, device, size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``iterator`` (dicts of numpy arrays) as tensors
    on ``device``, the copies of ``size`` batches in flight ahead of use.

    On a CUDA device each array is copied into pinned host memory and then
    to the card with ``non_blocking=True`` on a side stream; the consuming
    stream waits on the copy's event, and ``record_stream`` keeps the
    allocator from handing a batch's memory to another tensor before the
    consuming stream is done with it. On the CPU it yields plain tensors.
    """
    device = torch.device(device)

    def host(v):
        a = np.asarray(v)
        return torch.from_numpy(a if a.flags.writeable else a.copy())

    if device.type != "cuda":
        for batch in iterator:
            yield {k: host(v) for k, v in batch.items()}
        return

    import collections

    stream = torch.cuda.Stream(device)
    buf = collections.deque()

    def put(batch):
        with torch.cuda.stream(stream):
            out = {k: host(v).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        out, done = buf.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for v in out.values():
            v.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield out
