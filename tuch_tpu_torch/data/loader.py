"""Checkpointable, prefetching batch loader.

Copy of tuch_tpu/data/loader.py (the reference's CheckpointDataLoader):
  * thread-pool prefetch (image decode and warp release the GIL in PIL and
    numpy) into a bounded queue; batches come in order, each made by
    dataset.get(index, epoch), so they do not depend on the worker;
  * exact mid-epoch resume: the state is (epoch, batch_idx, perm_seed) and
    the permutation is drawn again from perm_seed + 7919 * epoch;
  * batches are dicts of stacked numpy arrays, padded to the batch size.
"""

import queue
import threading
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np


class LoaderState(NamedTuple):
    epoch: int
    batch_idx: int
    perm_seed: int


class CheckpointLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.drop_last = drop_last

    def num_batches(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _permutation(self, epoch: int,
                     perm_seed: Optional[int] = None) -> np.ndarray:
        # perm_seed comes from the LoaderState so a mid-epoch resume
        # regenerates the EXACT permutation of the checkpointed run even
        # if the process was relaunched with a different --seed
        base = self.seed if perm_seed is None else perm_seed
        if self.shuffle:
            rng = np.random.RandomState((base + 7919 * epoch)
                                        & 0x7fffffff)
            return rng.permutation(len(self.dataset))
        return np.arange(len(self.dataset))

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        keys = samples[0].keys()
        return {k: np.stack([s[k] for s in samples]) for k in keys}

    def _get_sample(self, idx: int, epoch: int):
        return self.dataset.get(int(idx), epoch)

    def epoch_iter(self, state: LoaderState
                   ) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate batches of one epoch starting at state.batch_idx."""
        perm = self._permutation(state.epoch, state.perm_seed)
        nb = self.num_batches()
        batches = range(state.batch_idx, nb)

        def make_batch(bi):
            lo = bi * self.batch_size
            idxs = perm[lo:lo + self.batch_size]
            while 0 < len(idxs) < self.batch_size:
                # pad final partial batch; loop because batch_size can
                # exceed the dataset length (tiny --synthetic runs)
                idxs = np.concatenate(
                    [idxs, perm[:self.batch_size - len(idxs)]])
            samples = [self._get_sample(i, state.epoch) for i in idxs]
            return self._collate(samples)

        if self.num_workers == 0:
            for bi in batches:
                yield make_batch(bi)
            return

        q: 'queue.Queue' = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """put() that wakes up if the consumer abandoned the iterator
            (otherwise the producer blocks forever on the full queue,
            leaking a deadlocked thread per interrupted epoch)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        error: list = []

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = []
                    for bi in batches:
                        if stop.is_set():
                            return
                        pending.append(pool.submit(make_batch, bi))
                        # pipeline depth scales with the worker pool so
                        # every worker can stay busy
                        while len(pending) > max(2, self.num_workers):
                            if not put_or_stop(pending.pop(0).result()):
                                return
                    for f in pending:
                        if not put_or_stop(f.result()):
                            return
            except BaseException as e:  # surface in the consumer: a
                # swallowed error would silently truncate the epoch
                error.append(e)
            finally:
                put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            stop.set()


def add_fits_indices(batch: Dict[str, np.ndarray], offsets_table: np.ndarray
                     ) -> Dict[str, np.ndarray]:
    """Attach packed fits-store row indices from (dataset_id, sample_index)."""
    batch = dict(batch)
    batch['fits_index'] = (offsets_table[batch['dataset_id']]
                           + batch['sample_index']).astype(np.int32)
    return batch
