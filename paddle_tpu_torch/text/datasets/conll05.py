"""CoNLL-2005 SRL test dataset (reference: text/datasets/conll05.py —
conll05st-release tarball: gzipped words/props column files; props
bracket notation decoded to B-/I-/O tag sequences, one sample per
(sentence, predicate))."""
from __future__ import annotations

import gzip
import tarfile

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["Conll05st"]

URL = "http://paddlemodels.bj.bcebos.com/conll05st/conll05st-tests.tar.gz"

_WORDS = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS = "conll05st-release/test.wsj/props/test.wsj.props.gz"


class Conll05st(Dataset):
    """Samples are (sentence words, predicate word, BIO label sequence);
    ids are left to the caller's vocabulary (the reference additionally
    ships frozen word/verb/target dicts — pass them through
    `word_dict`/`verb_dict`/`label_dict` to get id arrays)."""

    def __init__(self, data_file=None, word_dict=None, verb_dict=None,
                 label_dict=None, download=True):
        self.data_file = resolve_data_file(
            data_file, download, "conll05st", URL
        )
        self.word_dict = word_dict
        self.verb_dict = verb_dict
        self.label_dict = label_dict
        self._load()

    @staticmethod
    def _decode_props(col):
        """One predicate's bracket column -> BIO tags."""
        tags, cur, inside = [], "O", False
        for tok in col:
            if tok == "*":
                tags.append("I-" + cur if inside else "O")
            elif tok == "*)":
                tags.append("I-" + cur)
                inside = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                tags.append("B-" + cur)
                inside = ")" not in tok
            else:
                raise RuntimeError(f"unexpected props label: {tok}")
        return tags

    def _load(self):
        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(self.data_file) as tf, \
                gzip.GzipFile(fileobj=tf.extractfile(_WORDS)) as wf, \
                gzip.GzipFile(fileobj=tf.extractfile(_PROPS)) as pf:
            words, cols = [], []
            for wline, pline in zip(wf, pf):
                word = wline.decode("utf-8", "ignore").strip()
                parts = pline.decode("utf-8", "ignore").strip().split()
                if not parts:  # sentence boundary
                    self._emit(words, cols)
                    words, cols = [], []
                    continue
                words.append(word)
                cols.append(parts)
            self._emit(words, cols)

    def _emit(self, words, cols):
        if not words:
            return
        verbs = [v for v in (row[0] for row in cols) if v != "-"]
        n_pred = len(cols[0]) - 1
        for i in range(n_pred):
            col = [row[i + 1] for row in cols]
            self.sentences.append(list(words))
            self.predicates.append(verbs[i])
            self.labels.append(self._decode_props(col))

    def __getitem__(self, idx):
        sent, pred, labels = (
            self.sentences[idx], self.predicates[idx], self.labels[idx]
        )
        if self.word_dict is not None:
            unk = self.word_dict.get("<unk>", 0)
            sent = np.array([self.word_dict.get(w.lower(), unk)
                             for w in sent])
            pred = np.array([self.verb_dict.get(pred, 0)])
            labels = np.array([self.label_dict[t] for t in labels])
        return sent, pred, labels

    def __len__(self):
        return len(self.sentences)
