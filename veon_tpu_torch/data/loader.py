"""Order-preserving batch loader with thread or process workers and
per-process sharding (counterpart of `veon_tpu/data/loader.py`): samples
decode on a pool, batches come out strictly in order, and
`shard=(rank, count)` strides the dataset so each process sees a disjoint
partition.

Process mode forks, as the reference package's loader does, also after
the CUDA context exists: a worker runs only the dataset's numpy and PIL
code (and `torch.load` of a reference `.tensor` cache on the CPU), never
CUDA.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts into one batch dict.

    numpy arrays of a common shape gain a leading batch axis; dicts recurse;
    strings / scalars / ragged arrays become lists (e.g. retrieval
    annotations with per-sample point counts).
    """
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, dict):
            out[key] = collate(vals)
        elif isinstance(first, np.ndarray) and all(
            isinstance(v, np.ndarray) and v.shape == first.shape and v.dtype == first.dtype
            for v in vals
        ):
            out[key] = np.stack(vals)
        else:
            out[key] = list(vals)
    return out


# process-mode worker state: the dataset is shipped ONCE per worker via the
# pool initializer (fork start method — cheap page-sharing on Linux), not
# re-pickled per batch; only batch indices go out and collated batches come
# back over the pipe.
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_load(batch_idx):
    return collate([_WORKER_DATASET[int(i)] for i in batch_idx])


class DataLoader:
    """Order-preserving threaded (or multi-process) loader.

    Args:
      dataset: indexable with __len__/__getitem__ returning a sample dict.
      batch_size: samples per batch.
      shuffle: reshuffle per epoch (seeded by `set_epoch`).
      num_workers: decode workers (also the prefetch depth in batches).
      drop_last: drop the trailing partial batch (train default).
      shard: optional (rank, count) — this loader sees dataset indices
        rank, rank+count, rank+2*count, ... (exact partition across ranks).
      mode: "thread" (default) or "process". Threads rely on PIL/numpy/the
        native decoder releasing the GIL — the pure-python pipeline parts
        (meta assembly, aug matrices) serialize, so thread scaling tops out
        (`utils/loader_bench.py --workers N --mode M` measures it).
        "process" sidesteps the GIL with a forked
        ProcessPoolExecutor at the cost of pickling each collated batch
        back through a pipe; the dataset must be picklable (ours is: infos
        + dataclass configs + numpy). mmcv's build_dataloader counterpart
        is worker processes too (`apis/train.py:186-200`).
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 2,
        drop_last: bool = True,
        shard: Optional[Tuple[int, int]] = None,
        mode: str = "thread",
    ):
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be thread|process, got {mode!r}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.num_workers = max(1, int(num_workers))
        self.drop_last = bool(drop_last)
        self.shard = shard
        self.mode = mode
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(12345 + self._epoch)
            rng.shuffle(idx)
        if self.shard is not None:
            rank, count = self.shard
            # pad (wrap-around) to a multiple of count so every rank gets
            # the same number of samples — unequal counts would deadlock
            # the lockstep collectives in the sharded train step
            # (torch DistributedSampler's padding semantics)
            pad = (-len(idx)) % count
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[rank::count]
        return idx

    def _batches(self) -> List[np.ndarray]:
        idx = self._indices()
        nb = len(idx) // self.batch_size
        rem = len(idx) - nb * self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]
        if rem and not self.drop_last:
            batches.append(idx[nb * self.batch_size:])
        return batches

    def __len__(self) -> int:
        return len(self._batches())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        if not batches:
            return

        def load(batch_idx: np.ndarray) -> Dict[str, Any]:
            return collate([self.dataset[int(i)] for i in batch_idx])

        if self.mode == "process":
            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("fork"),
                initializer=_process_worker_init,
                initargs=(self.dataset,),
            )
            submit = lambda b: pool.submit(_process_worker_load, b)  # noqa: E731
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            submit = lambda b: pool.submit(load, b)  # noqa: E731
        with pool:
            depth = self.num_workers + 1
            futures = [submit(b) for b in batches[:depth]]
            nxt = depth
            for i in range(len(batches)):
                yield futures[i].result()
                futures[i] = None  # release
                if nxt < len(batches):
                    futures.append(submit(batches[nxt]))
                    nxt += 1
