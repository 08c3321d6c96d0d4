"""Mixed-dataset composition with deterministic sampling.

Copy of tuch_tpu/data/mixed.py on this package's TuchDataset (the
reference's mixed_dataset.py semantics): meta-names ('dsc' -> 3 subsets,
'dsc_eft' -> 3), shares re-weighted by subset size within each in-the-wild
group, and a categorical draw per item that is a pure function of (seed,
epoch, index) through crc32, so a resumed run sees the same stream and both
packages draw the same datasets.
"""

import zlib
from typing import Dict, List, Optional

import numpy as np

from tuch_tpu_torch.data.dataset import TuchDataset

_DSC_SUBSETS = ['dsc_lspet', 'dsc_lsp', 'dsc_df']
_DSC_EFT_SUBSETS = ['dsc_lspet_eft', 'dsc_lsp_eft', 'dsc_df_eft']
_ITW_DATASETS = ['mpii', 'coco', 'mpii_eft', 'coco_eft']
_ITW_DC_DATASETS = _DSC_SUBSETS + _DSC_EFT_SUBSETS


def expand_meta_names(names: List[str], partition: List[float]):
    """'dsc'/'dsc_eft' meta-entries -> their three subsets
    (reference mixed_dataset.py:33-46)."""
    names = list(names)
    partition = list(partition)
    for meta, subsets in (('dsc', _DSC_SUBSETS), ('dsc_eft',
                                                  _DSC_EFT_SUBSETS)):
        if meta in names:
            i = names.index(meta)
            share = partition[i]
            names = [n for j, n in enumerate(names) if j != i]
            partition = [p for j, p in enumerate(partition) if j != i]
            names += subsets
            partition += [share] * 3
    return names, partition


class MixedDataset:
    def __init__(self, options, split: str = 'train',
                 datasets: Optional[List[TuchDataset]] = None, **kwargs):
        if datasets is not None:
            # Explicit dataset objects (tests / synthetic runs): use their
            # names, equal shares unless options matches.
            names = [ds.name for ds in datasets]
            partition = [1.0 / len(datasets)] * len(datasets)
        elif split == 'train':
            names = list(options.ds_names)
            partition = list(options.ds_composition)
            names, partition = expand_meta_names(names, partition)
        else:
            names, partition = ['mtp'], [1.0]

        self.dataset_list = names
        self.dataset_dict = {n: i for i, n in enumerate(names)}
        if datasets is None:
            datasets = [TuchDataset(options, n, split=split, dataset_id=i,
                                    **kwargs) for i, n in enumerate(names)]
        self.datasets = datasets
        self.length = max(len(ds) for ds in self.datasets)
        self.total_length = sum(len(ds) for ds in self.datasets)
        self.seed = getattr(options, 'seed', 0)

        if split == 'train':
            # Re-weight shares within each in-the-wild group by subset size
            # (reference mixed_dataset.py:53-71).
            for group in (_ITW_DATASETS, _ITW_DC_DATASETS):
                idx = [i for i, n in enumerate(names) if n in group]
                if idx:
                    lens = [len(self.datasets[i]) for i in idx]
                    total = sum(lens)
                    for l, i in zip(lens, idx):
                        partition[i] = partition[i] * l / total
        self.partition = np.cumsum(np.array(partition, np.float64))

    def __len__(self):
        return self.length

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        key = f'mixed|{self.seed}|{epoch}|{int(index)}'.encode()
        rng = np.random.RandomState(zlib.crc32(key) & 0x7fffffff)
        p = rng.rand() * self.partition[-1]
        ds_i = int(np.searchsorted(self.partition, p))
        ds_i = min(ds_i, len(self.datasets) - 1)
        return self.datasets[ds_i].get(index, epoch)

    def dataset_sizes(self) -> Dict[str, int]:
        return {n: len(ds) for n, ds in zip(self.dataset_list,
                                            self.datasets)}
