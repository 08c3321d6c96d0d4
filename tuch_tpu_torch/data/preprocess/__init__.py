"""Offline extraction of the training and test databases.

Counterpart of tuch_tpu/data/preprocess/. The JAX extractors write each
database with joblib.dump; the port writes a plain pickle of the same dict
(write_db), which joblib.load, pickle.load and the port's loader
(data/dataset.py) all read, so the port needs no joblib.
"""

import pickle


def write_db(db: dict, path: str) -> None:
    """Write one extracted database (a dict of per-sample lists or
    arrays) to `path` as a plain pickle."""
    with open(path, 'wb') as f:
        pickle.dump(db, f, protocol=pickle.HIGHEST_PROTOCOL)
