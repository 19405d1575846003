"""``mx.contrib.text`` — the port of ``mxnet_tpu/contrib/text.py``
(MXNet's ``python/mxnet/contrib/text/``: ``utils.py``, ``vocab.py``,
``embedding.py``): token counting, index <-> token vocabularies with
reserved and unknown tokens, and token embeddings read from the
word-vector text format (``token v0 v1 ... vD`` a line, GloVe's and
fastText's layout, fastText's ``<count> <dim>`` header skipped).
Pretrained files are not downloaded: ``CustomEmbedding`` reads a local
file, as MXNet's does.  The vector table is an NDArray on the current
context.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..base import MXNetError
from .. import ndarray as nd

__all__ = ["count_tokens_from_str", "Vocabulary", "CustomEmbedding",
           "CompositeEmbedding"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """A corpus string's tokens counted (a ``collections.Counter``)."""
    source = source_str.lower() if to_lower else source_str
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    for seq in source.split(seq_delim):
        counter.update(t for t in seq.split(token_delim) if t)
    return counter


class Vocabulary:
    """Index <-> token map.  Tokens rank by frequency, ties
    alphabetically; index 0 is the unknown token and the reserved tokens
    follow it.  ``most_freq_count`` caps the counted tokens after the
    special ones are set apart."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise MXNetError("unknown_token must not be in reserved_tokens")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise MXNetError("reserved_tokens must be unique")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            special = set(self._idx_to_token)
            pairs = [kv for kv in sorted(counter.items(),
                                         key=lambda kv: (-kv[1], kv[0]))
                     if kv[0] not in special]
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq >= min_freq:
                    self._idx_to_token.append(tok)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """A token's index, or a list's; an unknown token is 0."""
        if isinstance(tokens, str):
            return self._token_to_idx.get(tokens, 0)
        return [self._token_to_idx.get(t, 0) for t in tokens]

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        out = []
        for i in ([indices] if single else indices):
            if not 0 <= i < len(self._idx_to_token):
                raise MXNetError(f"token index {i} out of range")
            out.append(self._idx_to_token[i])
        return out[0] if single else out


class CustomEmbedding(Vocabulary):
    """Token vectors read from a word-vector text file
    (``token<elem_delim>v0<elem_delim>...vD`` a line); an unknown token
    maps to ``init_unknown_vec`` (zeros by default).  With a
    ``vocabulary``, only its tokens that the file has are kept."""

    def __init__(self, pretrained_file_path, elem_delim=" ", encoding="utf8",
                 vocabulary=None, init_unknown_vec=None,
                 unknown_token="<unk>"):
        super().__init__(counter=None, unknown_token=unknown_token)
        vecs = {}
        vec_len = None
        with open(pretrained_file_path, encoding=encoding) as f:
            for line_num, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if len(parts) < 2:
                    continue
                if line_num == 0 and len(parts) == 2:
                    try:            # fastText's '<n_tokens> <dim>' header
                        int(parts[0]), int(parts[1])
                        continue
                    except ValueError:
                        pass
                tok, elems = parts[0], parts[1:]
                if vec_len is None:
                    vec_len = len(elems)
                elif len(elems) != vec_len:
                    raise MXNetError(
                        f"line {line_num + 1}: vector length {len(elems)} "
                        f"!= {vec_len}")
                if tok and tok not in vecs:
                    vecs[tok] = np.asarray([float(x) for x in elems],
                                           np.float32)
        if vec_len is None:
            raise MXNetError(f"no vectors found in {pretrained_file_path}")
        self._vec_len = vec_len
        if vocabulary is not None:
            keep = [t for t in vocabulary.idx_to_token
                    if t in vecs and t != self._unknown_token]
        else:
            keep = sorted(vecs)
        self._idx_to_token = [self._unknown_token] + keep
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        unk = init_unknown_vec(shape=(vec_len,)) if init_unknown_vec \
            else np.zeros((vec_len,), np.float32)
        table = np.stack([np.asarray(unk, np.float32).reshape(-1)]
                         + [vecs[t] for t in keep])
        self._idx_to_vec = nd.array(table)

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """The vector of a token, or of each of a list's (gathered on the
        table's device)."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        if lower_case_backup:
            toks = [t if t in self._token_to_idx else t.lower()
                    for t in toks]
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        vecs = self._idx_to_vec[nd.array(np.asarray(idx, np.int64),
                                         ctx=self._idx_to_vec.ctx,
                                         dtype=np.int64)]
        return vecs[0] if single else vecs

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite known tokens' vectors (an unknown token raises); only
        their rows are written, on the table's device, into a new
        table."""
        toks = [tokens] if isinstance(tokens, str) else list(tokens)
        arr = new_vectors.asnumpy() if hasattr(new_vectors, "asnumpy") \
            else np.asarray(new_vectors)
        arr = np.asarray(arr, self._idx_to_vec.dtype).reshape(len(toks), -1)
        for t in toks:
            if t not in self._token_to_idx:
                raise MXNetError(
                    f"token {t!r} is unknown; only known-token vectors can "
                    "be updated")
        old = self._idx_to_vec._data
        idx = torch.as_tensor([self._token_to_idx[t] for t in toks],
                              dtype=torch.int64, device=old.device)
        table = old.clone()
        table[idx] = torch.as_tensor(arr, device=old.device)
        self._idx_to_vec = nd.NDArray(table, self._idx_to_vec._ctx)


class CompositeEmbedding(Vocabulary):
    """Several embeddings' vectors a token, concatenated, over one
    vocabulary."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(token_embeddings, (list, tuple)):
            token_embeddings = [token_embeddings]
        super().__init__(counter=None,
                         unknown_token=vocabulary.unknown_token,
                         reserved_tokens=vocabulary.reserved_tokens)
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._embeds = list(token_embeddings)
        self._vec_len = sum(e.vec_len for e in self._embeds)
        parts = [e.get_vecs_by_tokens(self._idx_to_token).asnumpy()
                 for e in self._embeds]
        self._idx_to_vec = nd.array(np.concatenate(parts, axis=1))

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    get_vecs_by_tokens = CustomEmbedding.get_vecs_by_tokens
