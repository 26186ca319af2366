"""Host-side data pipeline, the port's copy of ``nmrf_tpu/data/loader.py``
(in place of the reference's torch DataLoader + DistributedSampler,
``datasets.py:383-436``): each process reads its own shard of every global
batch, workers decode and augment in a thread or a spawn process pool, and
batches are prefetched ahead of the training step.  The sampler's indices
and, in process mode, the per-sample seeds are those of the JAX package,
so the same samples and augmentation draws come out in the same order.
"""

import queue
import threading
from typing import Iterator, Optional

import numpy as np

# ---- process-pool worker state (spawn context: workers import the data
# subpackage; the dataset object is pickled once per worker at pool
# creation, not per sample) ----
_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _load_indexed(args):
    """Load one sample, seeding the global RNGs per SAMPLE (not per worker,
    as torch's DataLoader does): augmentation draws are then a pure function
    of (loader seed, epoch, rank, step, slot) — fully reproducible
    regardless of worker scheduling.  Both generators the augmentors use are
    seeded: numpy (spatial/eraser draws) and stdlib ``random``
    (ColorJitter/AdjustGamma, transforms.py)."""
    import random

    idx, seed = args
    if seed is not None:
        np.random.seed(seed)
        random.seed(seed + 1)
    return _WORKER_DATASET[int(idx)]


def _sample_seed(base_seed, epoch, rank, step, slot) -> int:
    return int(np.random.SeedSequence(
        (base_seed, epoch, rank, step, slot)).generate_state(1)[0])


class ShardedBatchSampler:
    """Deterministic epoch shuffling + contiguous per-process batch shards.

    Mirrors torch DistributedSampler(+set_epoch): permutation seeded by
    (seed, epoch), padded to a multiple of world_size * batch, each rank takes
    a strided slice.
    """

    def __init__(self, dataset_len, global_batch, rank=0, world_size=1,
                 seed=0, shuffle=True, drop_last=True):
        if global_batch % world_size:
            raise ValueError(f"global batch {global_batch} does not divide "
                             f"over {world_size} processes")
        self.n = dataset_len
        self.global_batch = global_batch
        self.local_batch = global_batch // world_size
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            perm = rng.permutation(self.n)
        else:
            perm = np.arange(self.n)
        if self.drop_last:
            usable = (self.n // self.global_batch) * self.global_batch
            perm = perm[:usable]
        else:
            pad = (-len(perm)) % self.global_batch
            perm = np.concatenate([perm, perm[:pad]])
        # [steps, world, local_batch] -> this rank's slice
        steps = len(perm) // self.global_batch
        perm = perm.reshape(steps, self.world_size, self.local_batch)
        return perm[:, self.rank, :]  # [steps, local_batch]


def _stack_batch(samples):
    out = {}
    for k in samples[0]:
        if k == "meta":
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


class PrefetchLoader:
    """Threaded prefetch iterator over a dataset + sampler.

    Emits dicts of stacked numpy arrays [local_batch, ...]; the caller moves
    them to the device (``parallel.device_prefetch``).

    ``use_processes=True`` decodes/augments in a persistent spawn-context
    process pool instead (the torch ``num_workers`` equivalent): PIL decode
    and the numpy augmentors hold the GIL, so threads cap throughput at
    ~1 core; processes scale with cores at the cost of pickling each sample
    back.  Process mode also makes augmentation draws deterministic per
    (seed, epoch, rank, step, slot) — see ``_load_indexed``.

    ``start_epoch`` and ``start_step`` place a resumed run where the saved
    one stopped: the first epoch iterated is ``start_epoch``, from its batch
    ``start_step`` on (the later epochs whole), with the batches, indices
    and per-sample seeds that epoch had in the run that saved.
    """

    def __init__(self, dataset, sampler: ShardedBatchSampler, num_workers=4,
                 prefetch=2, start_epoch=0, use_processes=False,
                 seed: Optional[int] = 0, start_step=0):
        self.dataset = dataset
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.epoch = start_epoch
        self.start_step = start_step
        self.use_processes = use_processes
        self.seed = seed
        self._pool = None

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
        return self._pool

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator[dict]:
        epoch = self.epoch
        indices = self.sampler.epoch_indices(epoch)
        first, self.start_step = self.start_step, 0
        self.epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            # gives up once the consumer has stopped (a run that ends
            # mid-epoch), so the thread does not block on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                if self.use_processes:
                    pool = self._process_pool()
                    rank = self.sampler.rank
                    for step, batch_idx in enumerate(indices[first:], first):
                        tasks = [
                            (idx, None if self.seed is None else
                             _sample_seed(self.seed, epoch, rank, step, j))
                            for j, idx in enumerate(batch_idx)]
                        samples = list(pool.map(_load_indexed, tasks))
                        if not put(_stack_batch(samples)):
                            return
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        for batch_idx in indices[first:]:
                            samples = list(
                                pool.map(self.dataset.__getitem__, batch_idx))
                            if not put(_stack_batch(samples)):
                                return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self):
        return self.sampler.epoch_indices(self.epoch).shape[0]


class InferenceSampler:
    """Contiguous uneven eval sharding: union of ranks == exact dataset
    (reference ``nmrf/utils/evaluation.py:42-75``)."""

    def __init__(self, size, rank=0, world_size=1):
        shard_size = size // world_size
        left = size % world_size
        shard_sizes = [shard_size + int(r < left) for r in range(world_size)]
        begin = sum(shard_sizes[:rank])
        self.indices = list(range(begin, begin + shard_sizes[rank]))

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)
