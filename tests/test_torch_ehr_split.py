"""The port's numpy stratified 80/10/10 split against the JAX package's
(sklearn's train_test_split twice) on the CPU: binary labels balanced and at
5% positives, 10-class length-of-stay labels, the unstratified multi-label
tasks, n from 10 to 5,000, seeds 0, 1 and 42, and the same exception type
where sklearn raises."""

import numpy as np
import pytest

from medtok_tpu.ehr.train import stratified_split as jax_split
from medtok_tpu_torch.ehr.train import stratified_split


def _labels(kind: str, n: int, seed: int) -> tuple[np.ndarray, str]:
    rng = np.random.default_rng(1000 * seed + n)
    if kind == "balanced":
        return rng.integers(0, 2, n), "readmission"
    if kind == "rare":
        return (rng.random(n) < 0.05).astype(np.int64), "mortality"
    if kind == "lenofstay":
        return rng.integers(0, 10, n), "lenofstay"
    return rng.integers(0, 2, (n, 4)), kind


def _outcome(fn, labels, task, seed):
    try:
        return fn(labels, task, seed), None
    except Exception as e:  # the exception type is part of the contract
        return None, type(e)


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("n", [10, 37, 250, 5000])
@pytest.mark.parametrize("kind", ["balanced", "rare", "lenofstay", "phenotype", "drugrec"])
def test_split_matches_sklearn(kind, n, seed):
    labels, task = _labels(kind, n, seed)
    want, want_err = _outcome(jax_split, labels, task, seed)
    got, got_err = _outcome(stratified_split, labels, task, seed)
    assert got_err == want_err
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert sorted(np.concatenate(got).tolist()) == list(range(n))


@pytest.mark.parametrize("labels,task", [
    (np.array([0] * 9 + [1]), "readmission"),          # a class with one member
    (np.array([0, 1] * 4 + [2, 2]), "lenofstay"),      # too few for 3 test classes
    (np.arange(20) % 10, "lenofstay"),                  # 10 classes, test of 4
    (np.array([0]), "readmission"),                     # an empty train set
    (np.zeros((1, 3), np.int64), "phenotype"),
    (np.array([0, 0, 1, 1, 1]), "mortality"),
])
def test_split_raises_where_sklearn_raises(labels, task):
    want, want_err = _outcome(jax_split, labels, task, 42)
    got, got_err = _outcome(stratified_split, labels, task, 42)
    assert got_err == want_err
    if want is None:
        assert got_err is ValueError
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
