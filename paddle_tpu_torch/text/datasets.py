"""Text datasets (counterpart of paddle_tpu/text/datasets.py; reference
python/paddle/text/datasets/: conll05.py, imdb.py, imikolov.py,
movielens.py, uci_housing.py, wmt14.py, wmt16.py).

Each dataset is the JAX package's deterministic synthetic corpus, item
for item: shape-, dtype- and vocabulary-faithful to the original, and
learnable (labels correlate with token content), so training on it shows
real dynamics. As in the JAX package, `data_file` and the dictionary
files are accepted and not read: reading the real archives is not ported
in either package.
"""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset

__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16"]


def _rng(mode, salt):
    return np.random.RandomState((42 if mode == "train" else 7) + salt)


class Imdb(Dataset):
    """IMDB sentiment (ref imdb.py:33): items are (doc_ids, label).

    Synthetic corpus: two disjoint "sentiment" token ranges; the label is
    which range dominates the document — linearly separable, so a bag-of-
    words classifier converges."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 synthetic_size=None):
        self.mode = mode
        self.word_idx = {f"w{i}": i for i in range(5148)}
        self.word_idx["<unk>"] = len(self.word_idx)
        n = synthetic_size or (1024 if mode == "train" else 256)
        rng = _rng(mode, 11)
        self.docs, self.labels = [], []
        for i in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 100))
            # sentiment tokens: [100,600) positive, [600,1100) negative
            pool = 100 + 500 * (1 - label)
            n_sent = max(1, length // 4)
            sent = rng.randint(pool, pool + 500, n_sent)
            rest = rng.randint(1100, 5148, length - n_sent)
            doc = np.concatenate([sent, rest])
            rng.shuffle(doc)
            self.docs.append(doc.astype(np.int64))
            self.labels.append(label)

    def __getitem__(self, idx):
        return self.docs[idx], np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset (ref imikolov.py:31): each item is an
    n-gram tuple (w0..w_{n-2}, w_{n-1}) under data_type='NGRAM', or the
    whole padded sentence under 'SEQ'."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, synthetic_size=None):
        if data_type not in ("NGRAM", "SEQ"):
            raise ValueError("data_type must be NGRAM or SEQ")
        self.data_type = data_type
        n = window_size if window_size > 0 else 5
        self.window_size = n
        vocab = 2000
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        rng = _rng(mode, 23)
        sents = synthetic_size or (2048 if mode == "train" else 256)
        self.data = []
        for _ in range(sents):
            # Markov-ish chain: next word = f(prev) + noise, learnable
            length = int(rng.randint(n, 20))
            sent = [int(rng.randint(0, vocab))]
            for _ in range(length - 1):
                nxt = (sent[-1] * 31 + 7) % vocab if rng.rand() < 0.7 \
                    else int(rng.randint(0, vocab))
                sent.append(nxt)
            if data_type == "NGRAM":
                for i in range(len(sent) - n + 1):
                    self.data.append(tuple(
                        np.asarray(w, np.int64) for w in sent[i:i + n]))
            else:
                pad = sent[:30] + [0] * max(0, 30 - len(sent))
                self.data.append(np.asarray(pad, np.int64))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """MovieLens-1M ratings (ref movielens.py:89): items are
    (user_id, gender, age, job, movie_id, category_vec, title_ids, rating).
    Synthetic ratings follow a low-rank user x movie affinity model."""

    NUM_USERS = 400
    NUM_MOVIES = 300

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, synthetic_size=None):
        rng = _rng(mode, 31)
        n = synthetic_size or (4096 if mode == "train" else 512)
        emb = np.random.RandomState(rand_seed)
        u_f = emb.randn(self.NUM_USERS, 4)
        m_f = emb.randn(self.NUM_MOVIES, 4)
        self.samples = []
        for _ in range(n):
            u = int(rng.randint(0, self.NUM_USERS))
            m = int(rng.randint(0, self.NUM_MOVIES))
            affinity = float(u_f[u] @ m_f[m])
            rating = float(np.clip(3.0 + affinity + rng.randn() * 0.3,
                                   1.0, 5.0))
            self.samples.append((
                np.asarray(u, np.int64),
                np.asarray(u % 2, np.int64),           # gender
                np.asarray(u % 7, np.int64),           # age bucket
                np.asarray(u % 21, np.int64),          # job
                np.asarray(m, np.int64),
                np.asarray([m % 18], np.int64),        # category
                np.asarray([m % 512, (m * 3) % 512], np.int64),  # title
                np.asarray(rating, np.float32)))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class UCIHousing(Dataset):
    """Boston housing regression (ref uci_housing.py:34): items are
    (13-dim feature, price). Synthetic: price is a fixed linear model of
    the features plus noise."""

    def __init__(self, data_file=None, mode="train", synthetic_size=None):
        n = synthetic_size or (404 if mode == "train" else 102)
        rng = _rng(mode, 47)
        w = np.random.RandomState(0).randn(13).astype(np.float32)
        self.x = rng.randn(n, 13).astype(np.float32)
        self.y = (self.x @ w + 2.0
                  + rng.randn(n).astype(np.float32) * 0.1)[:, None]

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


class _WMTBase(Dataset):
    """Shared synthetic parallel corpus: target = deterministic per-token
    mapping of source (a learnable toy 'translation'). Items are
    (src_ids, trg_ids, trg_ids_next) as in ref wmt14.py/wmt16.py."""

    START_ID, END_ID, UNK_ID = 0, 1, 2

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", synthetic_size=None):
        self.lang = lang
        self.src_dict_size = src_dict_size if src_dict_size > 0 else 1000
        self.trg_dict_size = trg_dict_size if trg_dict_size > 0 else 1000
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        rng = _rng(mode, 59)
        n = synthetic_size or (2048 if mode == "train" else 256)
        v_s, v_t = self.src_dict_size, self.trg_dict_size
        for _ in range(n):
            length = int(rng.randint(4, 30))
            src = rng.randint(3, v_s, length)
            trg = (src * 17 + 3) % (v_t - 3) + 3     # token-wise mapping
            s = np.concatenate([[self.START_ID], src, [self.END_ID]])
            t = np.concatenate([[self.START_ID], trg])
            t_next = np.concatenate([trg, [self.END_ID]])
            self.src_ids.append(s.astype(np.int64))
            self.trg_ids.append(t.astype(np.int64))
            self.trg_ids_next.append(t_next.astype(np.int64))

    def get_dict(self, lang=None, reverse=False):
        size = self.src_dict_size if (lang or self.lang) == "en" \
            else self.trg_dict_size
        d = {f"tok{i}": i for i in range(size)}
        return {v: k for k, v in d.items()} if reverse else d

    def __getitem__(self, idx):
        return (self.src_ids[idx], self.trg_ids[idx],
                self.trg_ids_next[idx])

    def __len__(self):
        return len(self.src_ids)


class WMT14(_WMTBase):
    """ref wmt14.py:41."""


class WMT16(_WMTBase):
    """ref wmt16.py:43."""


class Conll05st(Dataset):
    """CoNLL-2005 SRL (ref conll05.py:43): items are (word_ids, ctx_n2,
    ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, label_ids) — the
    standard 9-slot SRL input. Synthetic: labels derive from distance to
    the (single) predicate, so a window model can learn them."""

    WORD_DICT_LEN = 44068
    LABEL_DICT_LEN = 9
    PRED_DICT_LEN = 3162
    MAX_LEN = 30

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="train",
                 synthetic_size=None):
        rng = _rng(mode, 67)
        n = synthetic_size or (512 if mode == "train" else 64)
        self.word_dict = {f"w{i}": i for i in range(1000)}
        self.predicate_dict = {f"v{i}": i for i in range(100)}
        self.label_dict = {f"l{i}": i for i in range(self.LABEL_DICT_LEN)}
        self.samples = []
        L = self.MAX_LEN
        for _ in range(n):
            words = rng.randint(0, 1000, L).astype(np.int64)
            pred_pos = int(rng.randint(0, L))
            pred = np.full(L, int(words[pred_pos]) % 100, np.int64)
            mark = np.zeros(L, np.int64)
            mark[pred_pos] = 1
            dist = np.abs(np.arange(L) - pred_pos)
            labels = np.clip(dist, 0, self.LABEL_DICT_LEN - 1).astype(
                np.int64)
            ctx = [np.roll(words, s) for s in (2, 1, 0, -1, -2)]
            self.samples.append((words, *ctx, pred, mark, labels))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)

import sys as _sys  # noqa: E402


def _submodule(name, **attrs):
    mod = type(_sys)(__name__ + "." + name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    _sys.modules[__name__ + "." + name] = mod
    return mod


conll05 = _submodule("conll05", Conll05st=Conll05st)
imdb = _submodule("imdb", Imdb=Imdb)
imikolov = _submodule("imikolov", Imikolov=Imikolov)
movielens = _submodule("movielens", Movielens=Movielens)
uci_housing = _submodule("uci_housing", UCIHousing=UCIHousing)
wmt14 = _submodule("wmt14", WMT14=WMT14)
wmt16 = _submodule("wmt16", WMT16=WMT16)
