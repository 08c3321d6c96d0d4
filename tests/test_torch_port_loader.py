"""tuch_tpu_torch's loader and dataset mix against tuch_tpu's, bit for bit.

Both packages' TuchDataset, MixedDataset and CheckpointLoader over one
synthetic database (the port's synthetic_db, which draws the JAX package's
stream) yield equal batches, every key and every element. Each package
crops with its default warp: the native C++ warp of viz/native.cpp where
g++ builds it (tests/test_torch_port_crop.py), else the numpy warp. The
cases: one epoch, a later epoch, a mid-epoch resume, 0 workers against 4,
a loader seed other than the state's perm_seed, a batch larger than the
dataset, and add_fits_indices. Then tests/test_train.py's checks of the loader's
threads and errors and of the mix's share weighting, on the port's
modules.
"""

import gc
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tuch_tpu import config as jcfg
from tuch_tpu.data import loader as JL
from tuch_tpu.data import mixed as JMX
from tuch_tpu.data.dataset import TuchDataset as JDataset
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch.data import loader as PL
from tuch_tpu_torch.data import mixed as PMX
from tuch_tpu_torch.data.dataset import TuchDataset as PDataset
from tuch_tpu_torch.data.dataset import synthetic_db

N = 10


@pytest.fixture(scope='module')
def mixes(tmp_path_factory):
    """(JAX mix, port mix) of 'dsc_lsp' and 'mtp' over one database."""
    d = str(tmp_path_factory.mktemp('imgs'))
    db = synthetic_db(N, img_dir=d, seed=3)
    out = []
    for cfg_mod, ds_cls, mix_mod in ((jcfg, JDataset, JMX),
                                     (pcfg, PDataset, PMX)):
        opts = cfg_mod.TrainConfig(img_res=64, seed=3)
        datasets = [ds_cls(opts, name, data=db, img_dir=d, dataset_id=i)
                    for i, name in enumerate(['dsc_lsp', 'mtp'])]
        out.append(mix_mod.MixedDataset(opts, 'train', datasets=datasets))
    return out


CASES = {
    'epoch': dict(bs=4, state=(0, 0, 1), seed=1),
    'later_epoch': dict(bs=4, state=(2, 0, 1), seed=1),
    'mid_epoch_resume': dict(bs=2, state=(1, 2, 1), seed=1),
    'workers_4_against_0': dict(bs=2, state=(0, 0, 1), seed=1, workers=4),
    'perm_seed_not_seed': dict(bs=2, state=(0, 1, 7), seed=999),
    'batch_exceeds_dataset': dict(bs=3 * N - 1, state=(0, 0, 0), seed=0,
                                  drop_last=False),
    'no_shuffle': dict(bs=3, state=(0, 0, 0), seed=0, shuffle=False,
                       drop_last=False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_loader_batches_equal_jax(mixes, case):
    c = CASES[case]
    kw = dict(batch_size=c['bs'], shuffle=c.get('shuffle', True),
              seed=c['seed'], drop_last=c.get('drop_last', True))
    jmix, pmix = mixes
    jl = JL.CheckpointLoader(jmix, num_workers=0, **kw)
    pl = PL.CheckpointLoader(pmix, num_workers=c.get('workers', 0), **kw)
    assert pl.num_batches() == jl.num_batches()
    want = list(jl.epoch_iter(JL.LoaderState(*c['state'])))
    got = list(pl.epoch_iter(PL.LoaderState(*c['state'])))
    assert len(got) == len(want) > 0
    offsets = np.array([0, N], np.int32)
    for g, w in zip(got, want):
        g, w = PL.add_fits_indices(g, offsets), JL.add_fits_indices(w,
                                                                    offsets)
        assert set(g) == set(w)
        assert g['img'].shape[0] == c['bs']
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k


def test_mix_draws_equal_jax(mixes):
    jmix, pmix = mixes
    assert pmix.dataset_list == jmix.dataset_list
    np.testing.assert_array_equal(pmix.partition, jmix.partition)
    assert pmix.dataset_sizes() == jmix.dataset_sizes()
    for epoch in (0, 3):
        for i in range(N):
            assert pmix.get(i, epoch)['dataset_id'] == \
                jmix.get(i, epoch)['dataset_id']


def test_meta_name_expansion_equals_jax():
    for names, part in ((['dsc', 'mtp'], [0.5, 0.5]),
                        (['dsc_eft', 'mtp', 'dsc'], [0.2, 0.3, 0.5])):
        assert PMX.expand_meta_names(names, part) == \
            JMX.expand_meta_names(names, part)


def test_loader_abandoned_iterator_does_not_leak_thread(mixes):
    """Breaking out of epoch_iter mid-epoch stops its producer thread."""
    _, pmix = mixes
    before = threading.active_count()
    for _ in range(3):
        it = PL.CheckpointLoader(pmix, batch_size=2, shuffle=True,
                                 num_workers=2, seed=0).epoch_iter(
            PL.LoaderState(0, 0, 0))
        next(it)
        it.close()
    gc.collect()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_loader_propagates_worker_errors(mixes):
    """A failing sample read raises in the consumer; the epoch does not
    end early in silence."""
    _, pmix = mixes

    class Exploding:
        def __len__(self):
            return len(pmix)

        def get(self, i, epoch=0):
            if i == 5:
                raise RuntimeError('corrupt sample')
            return pmix.get(i, epoch)

    loader = PL.CheckpointLoader(Exploding(), batch_size=2, shuffle=False,
                                 num_workers=2, seed=0)
    with pytest.raises(RuntimeError, match='corrupt sample'):
        list(loader.epoch_iter(PL.LoaderState(0, 0, 0)))


def test_mixed_dataset_shares_match_reference_weighting(monkeypatch):
    """'dsc' expands to its three subsets, each drawn with share
    composition * len_i / group_len (the reference's mixed_dataset.py:
    33-71), and the empirical draw matches."""
    sizes = {'dsc_lspet': 60, 'dsc_lsp': 30, 'dsc_df': 10, 'mtp': 50}

    class DummyDS:
        def __init__(self, options, name, split='train', dataset_id=0,
                     **kw):
            self.name = name
            self._n = sizes[name]

        def __len__(self):
            return self._n

        def get(self, index, epoch=0):
            return {'dataset_name': self.name}

    monkeypatch.setattr(PMX, 'TuchDataset', DummyDS)
    opts = SimpleNamespace(ds_names=['dsc', 'mtp'],
                           ds_composition=[0.6, 0.4], seed=0)
    md = PMX.MixedDataset(opts, 'train')
    shares = np.diff(np.concatenate([[0.0], md.partition]))
    expect = {'dsc_lspet': 0.6 * 0.6, 'dsc_lsp': 0.6 * 0.3,
              'dsc_df': 0.6 * 0.1, 'mtp': 0.4}
    for name, share in zip(md.dataset_list, shares):
        np.testing.assert_allclose(share, expect[name], atol=1e-9)
    counts = {}
    for i in range(4000):
        nm = md.get(i)['dataset_name']
        counts[nm] = counts.get(nm, 0) + 1
    for name, share in expect.items():
        assert abs(counts.get(name, 0) / 4000 - share) < 0.03, (name, counts)
