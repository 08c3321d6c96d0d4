"""The EFT dataset: crop, keypoints and contact, no augmentation.

Counterpart of tuch_tpu/data/eft_dataset.py: TuchDataset without
augmentation, whose samples also carry the contact vector as 'contact'.
"""

from tuch_tpu_torch.data.dataset import TuchDataset


class EFTDataset(TuchDataset):
    def __init__(self, options, dataset: str, **kwargs):
        kwargs.setdefault('use_augmentation', False)
        super().__init__(options, dataset, **kwargs)

    def get(self, index: int, epoch: int = 0):
        sample = super().get(index, epoch)
        sample['contact'] = sample['contact_vec']
        return sample
