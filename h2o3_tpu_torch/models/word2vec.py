"""Word2Vec of the port (h2o3_tpu/models/word2vec.py; hex/word2vec):
skip-gram with negative sampling by mini-batch SGD.

The corpus is the frame's first column, one word a row, sentences
separated by NA. The vocabulary is the words seen at least
`min_word_freq` times, most frequent first. The training pairs are every
(center, context) of a sentence within `window_size` of each other, in
the reference's order: by sentence, by center, then by context position
ascending with the center skipped; here they are built at once from the
token stream (`_pairs`), where the reference loops. A step draws B =
min(1024, pairs) of them and `negative_samples` negatives a pair from the
unigram^0.75 distribution, and takes one SGD step on the summed loss
−Σ log σ(c·p) − Σ log σ(−c·n) at the rate 0.1·init_learning_rate, which
decays linearly to a tenth of it; each dense gradient is clipped to ±1
element by element (`_step`, by hand: gathers, the two sigmoid terms and
one `index_add_` a table). The JAX package always uses negative sampling
and never subsamples, whatever `norm_model` and `sent_sample_rate` say.

The draws (the initial vectors, each step's pairs and negatives) come
from `Draws`, which a test replaces. The negatives invert the unigram
CDF with `searchsorted` on uniforms, as numpy's `choice(p=)` does. The
`index_add_` of a step adds float gradients in an order that the card
does not fix, so two trainings on the card need not be bit-identical.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, Vec, T_STR
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.model import ModelBase
from h2o3_tpu_torch.parallel import mesh as _mesh


class Draws:
    """Word2Vec's random draws, from one torch.Generator on `device`."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed if seed > 0 else 0)
        self.device = torch.device(device)

    def init(self, V: int, dim: int) -> torch.Tensor:
        """(V, dim) f32 initial word vectors, U[-0.5/dim, 0.5/dim)."""
        u = torch.rand((V, dim), generator=self.gen, device=self.device)
        return (u - 0.5) / dim

    def pairs(self, B: int, npairs: int) -> torch.Tensor:
        """(B,) int64 indices into the pair list."""
        return torch.randint(0, npairs, (B,), generator=self.gen,
                             device=self.device)

    def negatives(self, B: int, neg: int, cdf: torch.Tensor) -> torch.Tensor:
        """(B, neg) int64 words drawn by the CDF `cdf` (float64, last 1)."""
        u = torch.rand((B, neg), generator=self.gen, device=self.device,
                       dtype=torch.float64)
        return torch.searchsorted(cdf, u, right=True)


def _words(frame: Frame) -> list:
    """The corpus column's words, None for NA."""
    v = frame.vecs[0]
    if v.type == T_STR:
        return list(v.host_data)
    dom = v.levels()
    return [None if np.isnan(c) else dom[int(c)] for c in v.to_numpy()]


def _pairs(words, vocab: dict, win: int):
    """The (center, context) pairs of the corpus `words` (None ends a
    sentence; words out of `vocab` are dropped), as int64 word ids in the
    reference's order: by sentence, by center, by context position."""
    code = np.fromiter((-2 if w is None else vocab.get(w, -1)
                        for w in words), np.int64, len(words))
    sent = np.cumsum(code == -2)[code >= 0]
    ids = code[code >= 0]
    n = ids.shape[0]
    offs = np.array([o for o in range(-win, win + 1) if o != 0], np.int64)
    j = np.arange(n)[:, None] + offs[None, :]             # (n, 2·win)
    jc = np.clip(j, 0, max(n - 1, 0))
    ok = (j >= 0) & (j < n) & (sent[jc] == sent[:, None])
    centers = np.broadcast_to(ids[:, None], j.shape)[ok]
    return centers, ids[jc[ok]]


def _step(syn0, syn1, c, ctx, neg, lr):
    """One SGD step on −Σ log σ(c·p) − Σ log σ(−c·n), the dense gradients
    clipped to ±1 element by element. Returns the new tables."""
    vc, vp, vn = syn0[c], syn1[ctx], syn1[neg]       # (B,d) (B,d) (B,k,d)
    gp = torch.sigmoid((vc * vp).sum(-1)) - 1.0      # d loss / d (c·p)
    gn = torch.sigmoid((vc[:, None, :] * vn).sum(-1))  # d loss / d (c·n)
    g_c = gp[:, None] * vp + (gn[:, :, None] * vn).sum(1)
    g_p = gp[:, None] * vc
    g_n = gn[:, :, None] * vc[:, None, :]
    g0 = torch.zeros_like(syn0).index_add_(0, c, g_c)
    g1 = torch.zeros_like(syn1).index_add_(0, ctx, g_p) \
        .index_add_(0, neg.reshape(-1), g_n.reshape(-1, syn1.shape[1]))
    return (syn0 - lr * g0.clamp_(-1.0, 1.0),
            syn1 - lr * g1.clamp_(-1.0, 1.0))


class H2OWord2vecEstimator(ModelBase):
    algo = "word2vec"
    supervised = False
    _defaults = {
        "vec_size": 100, "window_size": 5, "sent_sample_rate": 1e-3,
        "norm_model": "HSM", "epochs": 5, "min_word_freq": 5,
        "init_learning_rate": 0.025, "negative_samples": 5,
        "max_runtime_secs": 0.0,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("norm_model", "HSM",
         "the JAX package trains negative sampling under every norm_model "
         "(h2o3_tpu/models/word2vec.py:344-357)"),
        ("sent_sample_rate", 1e-3,
         "the JAX package never subsamples frequent words "
         "(h2o3_tpu/models/word2vec.py:311-320)"))

    def _draws(self, device):
        return Draws(int(self.params.get("seed") or -1), device)

    def train(self, training_frame=None, **kw):
        self.params.update(kw)
        self._check_ported()
        self.key = self.params.get("model_id") or DKV.make_key("word2vec")
        v = training_frame.vecs[0]
        self._device = v.device if v.data is not None \
            else _mesh.cloud().device
        self._fit_corpus(_words(training_frame))
        DKV.put(self.key, self)
        return self

    def _fit_corpus(self, words):
        min_freq = int(self.params["min_word_freq"])
        dim = int(self.params["vec_size"])
        win = int(self.params["window_size"])
        neg = int(self.params["negative_samples"])
        epochs = int(self.params["epochs"])
        lr = float(self.params["init_learning_rate"])
        dev = self._device
        # the vocabulary (WordCountTask)
        counts = Counter(w for w in words if w is not None)
        vocab = [w for w, c in counts.most_common() if c >= min_freq]
        self._vocab = {w: i for i, w in enumerate(vocab)}
        V = len(vocab)
        if V == 0:
            raise ValueError("empty vocabulary (lower min_word_freq?)")
        centers, contexts = _pairs(words, self._vocab, win)
        npairs = centers.shape[0]
        if npairs == 0:
            raise ValueError("no training pairs")
        centers = torch.from_numpy(centers).to(dev)
        contexts = torch.from_numpy(contexts).to(dev)
        freq = torch.tensor([counts[w] for w in vocab],
                            dtype=torch.float64) ** 0.75
        freq /= freq.sum()
        cdf = torch.cumsum(freq, 0)
        cdf = (cdf / cdf[-1]).to(dev)
        draws = self._draws(dev)
        syn0 = draws.init(V, dim).to(dev, torch.float32)
        syn1 = torch.zeros((V, dim), dtype=torch.float32, device=dev)
        B = min(1024, npairs)
        nsteps = max(1, epochs * npairs // B)
        # init_learning_rate is the reference's rate a pair; a summed batch
        # step applies about B pair updates at once
        step_lr = lr * 0.1
        for s in range(nsteps):
            idx = draws.pairs(B, npairs).to(dev)
            negs = draws.negatives(B, neg, cdf).to(dev)
            syn0, syn1 = _step(syn0, syn1, centers[idx], contexts[idx], negs,
                               step_lr * max(0.1, 1 - s / nsteps))
        self._pairs, self._steps = npairs, nsteps
        self._vectors = syn0
        self._vocab_list = vocab

    # ---- public surface (h2o-py H2OWord2vecEstimator) --------------------
    def find_synonyms(self, word: str, count: int = 20) -> dict:
        """The `count` words nearest `word` by cosine similarity, nearest
        first."""
        if word not in self._vocab:
            return {}
        V = self._vectors
        v = V[self._vocab[word]]
        sims = (V @ v) / (torch.linalg.vector_norm(V, dim=1)
                          * torch.linalg.vector_norm(v) + 1e-12)
        order = torch.argsort(-sims, stable=True)[: count + 1].tolist()
        sims = sims.cpu()
        out = {}
        for i in order:
            w = self._vocab_list[i]
            if w != word:
                out[w] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame, aggregate_method: str = "NONE") -> Frame:
        """Words to vectors (NaN for a word out of the vocabulary); AVERAGE
        pools each NA-terminated sentence into one row, the mean of its
        words' vectors (NaN for none). As in the reference, words after
        the last NA make no row unless the column has no NA at all."""
        words = _words(frame)
        V = self._vectors
        dev, dim = V.device, V.shape[1]
        lookup = self._vocab
        code = torch.tensor([-2 if w is None else lookup.get(w, -1)
                             for w in words], dtype=torch.int64)
        known = code >= 0
        if aggregate_method.upper() == "AVERAGE":
            brk = code == -2
            nrow = max(int(brk.sum()), 1)
            sent = torch.cumsum(brk.long(), 0)
            take = known & (sent < nrow)
            rows = sent[take].to(dev)
            acc = torch.zeros((nrow, dim), dtype=torch.float64, device=dev)
            acc.index_add_(0, rows, V[code[take].to(dev)].double())
            cnt = torch.zeros(nrow, dtype=torch.float64, device=dev) \
                .index_add_(0, rows, torch.ones(rows.shape[0],
                                                dtype=torch.float64,
                                                device=dev))
            mat = acc / cnt[:, None]              # 0/0: NaN for no words
        else:
            mat = torch.full((len(words), dim), float("nan"), device=dev)
            mat[known.to(dev)] = V[code[known].to(dev)]
        return Frame([f"V{i+1}" for i in range(dim)],
                     [Vec.from_tensor(mat[:, i]) for i in range(dim)])

    def to_frame(self) -> Frame:
        """The vocabulary (a Word column) and its vectors (V1..Vd)."""
        vec = self._vectors.double().cpu().numpy()
        cols = {"Word": np.asarray(self._vocab_list, object)}
        for i in range(vec.shape[1]):
            cols[f"V{i+1}"] = vec[:, i]
        return Frame.from_dict(cols)
