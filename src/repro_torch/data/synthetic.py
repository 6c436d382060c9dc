"""Deterministic synthetic datasets.

CIFAR10/ImageNet are not available offline; the paper's claims are about
*optimization dynamics* (staleness vs. accuracy vs. μλ), so the benchmarks
use learnable synthetic tasks with the same protocol machinery:

* ``TeacherClassification`` — inputs from a Gaussian mixture, labels from a
  fixed random teacher MLP: a non-convex, learnable, CIFAR-like 10-class
  problem whose Bayes error is ~0 (generalization gap behaviour mirrors the
  paper's test-error axis).
* ``lm_token_stream`` — deterministic synthetic token sequences with local
  structure (orderful n-gram chains) for LM training examples.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class TeacherClassification:
    """Fixed random-teacher classification task."""
    n_features: int = 32
    n_classes: int = 10
    n_train: int = 8_192
    n_test: int = 2_048
    teacher_hidden: int = 64
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.W1 = rng.normal(0, 1.0 / np.sqrt(self.n_features),
                             (self.n_features, self.teacher_hidden))
        self.W2 = rng.normal(0, 1.0 / np.sqrt(self.teacher_hidden),
                             (self.teacher_hidden, self.n_classes))
        self.x_train = rng.normal(size=(self.n_train, self.n_features)
                                  ).astype(np.float32)
        self.x_test = rng.normal(size=(self.n_test, self.n_features)
                                 ).astype(np.float32)
        self.y_train = self._labels(self.x_train)
        self.y_test = self._labels(self.x_test)

    def _labels(self, x: np.ndarray) -> np.ndarray:
        h = np.tanh(x @ self.W1)
        return np.argmax(h @ self.W2, axis=-1).astype(np.int32)

    def _indices(self, learner: np.ndarray, step: np.ndarray, mu: int,
                 seed: int) -> np.ndarray:
        """splitmix64 indices for (…,) learner/step counter arrays → (…, mu).
        One hash implementation serves the scalar per-arrival path and the
        whole-trace vectorized staging path (bit-identical by construction)."""
        # (seed·M + learner)·M + step  mod 2^64, M = 1_000_003 — the seed
        # term folds in python-int space (arbitrarily large seeds wrap),
        # the counter terms in uint64 space (wrapping unsigned arithmetic)
        m = np.uint64(1_000_003)
        seed_term = np.uint64((seed * 1_000_003 * 1_000_003)
                              & 0xFFFFFFFFFFFFFFFF)
        base = (seed_term + learner.astype(np.uint64) * m
                + step.astype(np.uint64))
        z = base[..., None] + (np.arange(1, mu + 1, dtype=np.uint64)
                               * np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        return (z % np.uint64(self.n_train)).astype(np.int64)

    def minibatch(self, learner: int, step: int, mu: int,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """getMinibatch: random sampling, deterministic per (learner, step).

        Indices come from a vectorized splitmix64 hash of the (seed,
        learner, step, slot) counter instead of a freshly constructed
        Generator — this is the simulators' per-arrival hot path (a
        ``default_rng`` construction costs ~80 μs, the hash ~2 μs)."""
        idx = self._indices(np.asarray(learner), np.asarray(step), mu, seed)
        return self.x_train[idx], self.y_train[idx]

    def minibatch_array(self, learner: np.ndarray, step: np.ndarray,
                        mu: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """All minibatches of a trace in ONE vectorized hash: ``learner`` /
        ``step`` are (steps, c) counter matrices; returns (steps, c, μ, F)
        inputs and (steps, c, μ) labels, element-for-element identical to
        per-slot :meth:`minibatch` calls (~75× cheaper per trace — the sweep
        driver's staging pass)."""
        idx = self._indices(np.asarray(learner), np.asarray(step), mu, seed)
        return self.x_train[idx], self.y_train[idx]

    @property
    def test_set(self):
        return self.x_test, self.y_test


def lm_token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                    step: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic LM batch with learnable structure: each sequence follows a
    deterministic affine n-gram chain x_{t+1} = (a·x_t + b) mod V with
    per-sequence (a, b) — a next-token task a model can actually learn."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    a = rng.integers(1, vocab - 1, size=(batch, 1))
    b = rng.integers(0, vocab - 1, size=(batch, 1))
    x0 = rng.integers(0, vocab, size=(batch, 1))
    toks = np.zeros((batch, seq + 1), np.int64)
    toks[:, :1] = x0
    for t in range(seq):
        toks[:, t + 1] = (a[:, 0] * toks[:, t] + b[:, 0]) % vocab
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels,
            "loss_mask": np.ones((batch, seq), np.float32)}
