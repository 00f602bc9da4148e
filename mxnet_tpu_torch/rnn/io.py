"""Bucketed sentence iteration for language models (counterpart of
``mxnet_tpu/rnn/io.py``): ``encode_sentences`` and ``BucketSentenceIter``.

A sentence goes to the smallest bucket that holds it, padded with
``invalid_label`` (longer ones are dropped); each bucket is one dense
int32 token matrix, the label of a position is the next position's
token, and an epoch's plan is one ``(bucket, row offset)`` a full batch.
The plan's order and each bucket's row permutation are drawn at
``reset`` from the port's host generator (:mod:`mxnet_tpu_torch.random`,
not numpy's global one); ``state_dict`` / ``load_state`` carry them in
the reference's format, so either package replays the other's epoch.
Batches are host NDArrays, which the module copies to its device.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import random as _random
from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array

__all__ = ["BucketSentenceIter", "encode_sentences"]



def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sentences to integer-id sentences.

    With ``vocab=None`` a fresh vocabulary is grown in first-seen order
    starting at ``start_label`` (skipping ``invalid_label``, which is
    reserved for ``invalid_key``); with a supplied vocabulary, unseen
    tokens are an error.  Returns ``(encoded, vocab)``.
    """
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}

    def assign(token):
        if token in vocab:
            return vocab[token]
        if not grow:
            raise AssertionError("Unknown token %s" % token)
        nxt = assign.next_id
        if nxt == invalid_label:
            nxt += 1
        vocab[token] = nxt
        assign.next_id = nxt + 1
        return nxt

    assign.next_id = start_label
    encoded = [[assign(tok) for tok in sent] for sent in sentences]
    return encoded, vocab


def _permutation(n):
    """A permutation of ``range(n)`` from the port's host generator."""
    return torch.randperm(n, generator=_random.generator()).numpy()


def _auto_buckets(lengths, batch_size):
    """One bucket per sentence length that has at least a batch of data."""
    counts = np.bincount(lengths)
    return np.flatnonzero(counts >= batch_size).tolist()


class BucketSentenceIter(DataIter):
    """Bucketed iterator over variable-length token sequences.

    Sentences are padded with ``invalid_label`` up to the smallest bucket
    that fits them (longer ones are dropped with a logged count), and the
    label for each position is the token at the next position — the
    standard next-token LM target.  ``layout`` selects batch-major ``NT``
    or time-major ``TN`` batches; ``provide_data``/``provide_label`` carry
    the layout through :class:`DataDesc` so modules can locate the batch
    axis.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        lengths = np.array([len(s) for s in sentences], dtype=np.int64)
        if buckets:
            buckets = sorted(buckets)
        else:
            buckets = _auto_buckets(lengths, batch_size)
        if not buckets:
            raise ValueError("no buckets: pass `buckets` explicitly or "
                             "provide >= batch_size sentences per length")

        # smallest bucket that fits each sentence; == len(buckets) -> drop
        slot = np.searchsorted(np.asarray(buckets), lengths)
        dropped = int((slot == len(buckets)).sum())
        if dropped:
            logging.getLogger(__name__).warning(
                "BucketSentenceIter: dropped %d sentences longer than "
                "max bucket %d", dropped, buckets[-1])

        # one dense padded token matrix per bucket
        self._tokens = []
        for b, width in enumerate(buckets):
            rows = [np.asarray(sentences[i], dtype=np.int32)
                    for i in np.flatnonzero(slot == b)]
            mat = np.full((len(rows), width), invalid_label, dtype=np.int32)
            for r, row in enumerate(rows):
                mat[r, :row.size] = row
            self._tokens.append(mat)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError(
                "layout %r must contain N at position 0 (batch-major NT) "
                "or 1 (time-major TN)" % layout)
        self.default_bucket_key = max(buckets)

        self.provide_data = [
            DataDesc(data_name, self._shape_for(self.default_bucket_key),
                     layout=layout)]
        self.provide_label = [
            DataDesc(label_name, self._shape_for(self.default_bucket_key),
                     layout=layout)]

        # epoch plan: (bucket, row-offset) per full batch; partial batches
        # at the tail of a bucket are dropped, matching reference behavior
        self._plan = [(b, off)
                      for b, mat in enumerate(self._tokens)
                      for off in range(0, mat.shape[0] - batch_size + 1,
                                       batch_size)]
        self._perms = [np.arange(mat.shape[0]) for mat in self._tokens]
        self._cursor = 0
        self.reset()

    def _shape_for(self, seq_len):
        if self.major_axis == 0:
            return (self.batch_size, seq_len)
        return (seq_len, self.batch_size)

    def reset(self):
        self._cursor = 0
        order = _permutation(len(self._plan))
        self._plan = [self._plan[k] for k in order]
        self._perms = [_permutation(mat.shape[0]) for mat in self._tokens]
        self._epoch_state = None   # serialized plan/perms cache

    # -- checkpoint protocol ---------------------------------------------
    def state_dict(self):
        """Cursor + the epoch's drawn plan order and per-bucket row
        permutations, so a resumed iterator replays the identical
        bucketed batch stream (time-major or batch-major alike).  The
        plan/perms serialization is fixed within an epoch and cached:
        per-batch snapshots do not pay O(dataset) each time."""
        if getattr(self, "_epoch_state", None) is None:
            self._epoch_state = {
                "plan": [[int(b), int(off)] for b, off in self._plan],
                "perms": [[int(i) for i in p] for p in self._perms]}
        return {"version": 1, "kind": "BucketSentenceIter",
                "cursor": int(self._cursor),
                "plan": self._epoch_state["plan"],
                "perms": self._epoch_state["perms"]}

    def load_state(self, state):
        perms = state["perms"]
        if len(perms) != len(self._tokens) or any(
                len(p) != mat.shape[0]
                for p, mat in zip(perms, self._tokens)):
            raise ValueError("checkpoint bucket layout does not match "
                             "this iterator's data")
        self._plan = [(int(b), int(off)) for b, off in state["plan"]]
        self._perms = [np.asarray(p, dtype=np.int64) for p in perms]
        self._epoch_state = None
        self._cursor = int(state["cursor"])
        if self._cursor >= len(self._plan):
            # epoch-boundary capture: roll into a fresh epoch (a new
            # shuffle from the port's generator, a fresh draw rather than
            # a bit-exact replay)
            self.reset()

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        b, off = self._plan[self._cursor]
        self._cursor += 1

        rows = self._perms[b][off:off + self.batch_size]
        toks = self._tokens[b][rows]                       # (N, T) int32
        labs = np.roll(toks, -1, axis=1)
        labs[:, -1] = self.invalid_label
        if self.major_axis == 1:
            toks, labs = toks.T, labs.T

        data = array(toks.astype(self.dtype), ctx=cpu())
        label = array(labs.astype(self.dtype), ctx=cpu())
        key = self.buckets[b]
        return DataBatch(
            [data], [label], pad=0, bucket_key=key,
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
