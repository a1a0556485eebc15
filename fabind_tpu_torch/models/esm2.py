"""ESM2 protein encoder (the t33_650M architecture by default).

Own copy of fabind_tpu/models/esm2.py for PyTorch: a rotary self-attention
encoder with ESM's exact erf-GELU, the query scaled *before* the rotary, a
float32 softmax, the token-dropout rescale of the embeddings (the constant
0.88 factor at inference) and the trailing encoder LayerNorm. The modules
carry HuggingFace `EsmModel`'s parameter names, so a HuggingFace state dict
(`EsmModel` or the `esm.`-prefixed `EsmForMaskedLM`) loads through
`train.convert.load_esm_state_dict` with its leftovers dropped, and
`load_esm2` reads a local checkpoint file or directory.

Attention is plain PyTorch (two batched products around a float32 softmax),
as the JAX package has it in plain XLA: no TPU kernel computes it.

The token-dropout rescale divides by the masked length of each row, as the
JAX package does; HuggingFace's `EsmModel.forward` divides by the padded
length, so the two agree on unpadded rows only.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fabind_tpu_torch.parallel.dp import ReplicaSet, dp_devices

Tensor = torch.Tensor

# fair-esm alphabet, the token order all released ESM2 checkpoints use
ESM_VOCAB: List[str] = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
ESM_TOKEN_TO_ID = {t: i for i, t in enumerate(ESM_VOCAB)}
CLS_ID, PAD_ID, EOS_ID, UNK_ID, MASK_ID = 0, 1, 2, 3, 32


def tokenize(seq: str, pad_to: Optional[int] = None) -> np.ndarray:
    """<cls> + residues + <eos> (+ <pad>...), fair-esm token ids."""
    ids = ([CLS_ID] + [ESM_TOKEN_TO_ID.get(a, UNK_ID) for a in seq]
           + [EOS_ID])
    if pad_to is not None:
        if len(ids) > pad_to:
            raise ValueError(f"{len(ids)} tokens exceed pad_to {pad_to}")
        ids = ids + [PAD_ID] * (pad_to - len(ids))
    return np.asarray(ids, np.int32)


@dataclasses.dataclass(frozen=True)
class Esm2Config:
    """Defaults = esm2_t33_650M_UR50D."""

    vocab_size: int = 33
    hidden_size: int = 1280
    num_layers: int = 33
    num_heads: int = 20
    intermediate_size: int = 5120
    layer_norm_eps: float = 1e-5
    token_dropout: bool = True
    mask_ratio_train: float = 0.15 * 0.8


def _rotary_tables(L: int, dim: int, dtype, device) -> Tuple[Tensor, Tensor]:
    """cos/sin [L, dim], built in float32 numpy and cast to the stream
    dtype, as the JAX package builds them."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, np.float32) / dim))
    freqs = np.outer(np.arange(L, dtype=np.float32), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return tuple(torch.from_numpy(f(emb)).to(device, dtype)
                 for f in (np.cos, np.sin))


def _apply_rotary(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    # x: [B, H, L, D]; cos/sin: [L, D]
    d = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., d:], x[..., :d]], dim=-1) * sin


class _Dense(nn.Module):
    """A module whose one child is `dense` (HuggingFace's naming)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class _SelfAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class _Attention(nn.Module):
    def __init__(self, cfg: Esm2Config):
        super().__init__()
        h = cfg.hidden_size
        self.self = _SelfAttention(h)
        self.output = _Dense(h, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)


class Esm2Layer(nn.Module):
    """One pre-LayerNorm block: rotary self-attention, then the erf-GELU
    feed-forward, each added to the residual stream."""

    def __init__(self, cfg: Esm2Config):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h: Tensor, bias: Tensor, cos: Tensor, sin: Tensor
                ) -> Tensor:
        B, L, C = h.shape
        H = self.num_heads
        D = C // H
        att = self.attention
        x = att.LayerNorm(h)
        q, k, v = (lin(x).view(B, L, H, D).transpose(1, 2)
                   for lin in (att.self.query, att.self.key, att.self.value))
        q = _apply_rotary(q * D ** -0.5, cos, sin)   # scale BEFORE rotary
        k = _apply_rotary(k, cos, sin)
        logits = q @ k.transpose(-1, -2) + bias
        w = torch.softmax(logits.float(), dim=-1).to(h.dtype)
        o = (w @ v).transpose(1, 2).reshape(B, L, C)
        h = h + att.output.dense(o)
        x = F.gelu(self.intermediate.dense(self.LayerNorm(h)),
                   approximate="none")
        return h + self.output.dense(x)


class _Embeddings(nn.Module):
    def __init__(self, cfg: Esm2Config):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: Esm2Config):
        super().__init__()
        self.layer = nn.ModuleList(Esm2Layer(cfg)
                                   for _ in range(cfg.num_layers))
        self.emb_layer_norm_after = nn.LayerNorm(cfg.hidden_size,
                                                 eps=cfg.layer_norm_eps)


class Esm2Model(nn.Module):
    """Encoder returning the final-layer hidden states [B, L, hidden]."""

    def __init__(self, cfg: Esm2Config = Esm2Config()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        cfg = self.cfg
        emb = self.embeddings.word_embeddings(input_ids)
        dtype = emb.dtype
        if cfg.token_dropout:
            is_mask = input_ids == MASK_ID
            emb = emb.masked_fill(is_mask[..., None], 0.0)
            observed = (is_mask.sum(-1).to(dtype)
                        / attention_mask.sum(-1).to(dtype))
            emb = emb * ((1.0 - cfg.mask_ratio_train)
                         / (1.0 - observed))[:, None, None]
        h = emb * attention_mask[..., None].to(dtype)
        bias = (1.0 - attention_mask[:, None, None, :].to(dtype)) * -1e9
        cos, sin = _rotary_tables(input_ids.shape[1],
                                  cfg.hidden_size // cfg.num_heads, dtype,
                                  input_ids.device)
        for layer in self.encoder.layer:
            h = layer(h, bias, cos, sin)
        return self.encoder.emb_layer_norm_after(h)

    def embed_sequences(self, seqs: List[str], pad_multiple: int = 128,
                        batch_size: int = 1, dp=1) -> List[np.ndarray]:
        """Per-sequence embeddings [len, hidden] as float32 numpy arrays,
        <cls>/<eos> stripped, in input order, computed on the module's
        device in its dtype (move and cast the module once; float32 is
        the JAX package's default).

        Sequences are bucketed by their length padded to `pad_multiple`;
        each forward takes `batch_size` rows of one bucket, the tail of a
        bucket filled by repeating its last row, so every forward of a
        bucket has one shape. Batching is exact up to reduction order:
        padded positions are masked out of attention and of the
        token-dropout rescale.

        Data parallelism (JAX's `embed_sequences(mesh=)`): `dp` replicas
        (an int: cards 0..dp-1 of the module's device type, 0 = every
        visible card; or a sequence of devices) hold copies of the encoder
        for the call, the module itself on the first; each forward then
        takes batch_size x dp rows, batch_size on each replica, in threads
        of their own. `dp` may also be a parallel.dp.ReplicaSet of this
        encoder that the caller holds across calls."""
        p = next(self.parameters())
        replicas = own = None
        if isinstance(dp, ReplicaSet):
            replicas = dp
        elif dp != 1:
            devices = (list(dp) if isinstance(dp, (list, tuple))
                       else dp_devices(p.device, dp))
            replicas = own = ReplicaSet(self, devices)
        n_rep = 1 if replicas is None else len(replicas)
        rows = batch_size * n_rep
        buckets: dict = {}
        for i, seq in enumerate(seqs):
            pad = -(-(len(seq) + 2) // pad_multiple) * pad_multiple
            buckets.setdefault(pad, []).append(i)
        out: List = [None] * len(seqs)
        try:
            with torch.inference_mode():
                for pad in sorted(buckets):
                    idxs = buckets[pad]
                    for c0 in range(0, len(idxs), rows):
                        chunk = idxs[c0:c0 + rows]
                        ids = np.stack([tokenize(seqs[i], pad_to=pad)
                                        for i in chunk])
                        if len(chunk) < rows:
                            ids = np.concatenate([ids, np.repeat(
                                ids[-1:], rows - len(chunk), 0)], 0)
                        ids_t = torch.from_numpy(ids.astype(np.int64))
                        if replicas is None:
                            h = _embed_ids(self, ids_t.to(p.device))
                        else:
                            h = np.concatenate(replicas.map(
                                lambda r, part: _embed_ids(
                                    replicas.modules[r],
                                    part.to(replicas.devices[r])),
                                [ids_t[s] for s in replicas.blocks(rows)]))
                        for row, i in enumerate(chunk):
                            out[i] = h[row, 1:len(seqs[i]) + 1]
        finally:
            if own is not None:
                own.close()
        return out


def _embed_ids(model: Esm2Model, ids: Tensor) -> np.ndarray:
    """One forward of token ids [B, L] on their device -> float32 numpy."""
    return model(ids, (ids != PAD_ID).to(torch.int32)).float().cpu().numpy()


def _config_from_state_dict(sd, num_heads: int) -> Esm2Config:
    """The encoder's shape from its tensors; the head count is not in the
    shapes and comes from the caller."""
    n_layers = len({k.split(".")[2] for k in sd
                    if k.startswith("encoder.layer.")})
    vocab, hidden = sd["embeddings.word_embeddings.weight"].shape
    inter = sd["encoder.layer.0.intermediate.dense.weight"].shape[0]
    return Esm2Config(vocab_size=vocab, hidden_size=hidden,
                      num_layers=n_layers, num_heads=num_heads,
                      intermediate_size=inter)


def load_esm2(path: str, num_heads: int = Esm2Config.num_heads
              ) -> Esm2Model:
    """An Esm2Model in eval mode on the CPU from local files, never the
    network: a HuggingFace directory (its `config.json` and
    `pytorch_model.bin` or `model.safetensors`), or a torch state dict file
    (`EsmModel` or `esm.`-prefixed names), whose shape comes from its
    tensors and whose head count from `num_heads` (20 for ESM2 up to
    650M)."""
    from fabind_tpu_torch.train.convert import load_esm_state_dict
    if os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            tc = json.load(f)
        cfg = Esm2Config(
            vocab_size=tc["vocab_size"], hidden_size=tc["hidden_size"],
            num_layers=tc["num_hidden_layers"],
            num_heads=tc["num_attention_heads"],
            intermediate_size=tc["intermediate_size"],
            layer_norm_eps=tc.get("layer_norm_eps", 1e-5),
            token_dropout=tc.get("token_dropout", True))
        weights = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(weights):
            sd = torch.load(weights, map_location="cpu", weights_only=True)
        else:
            from safetensors.torch import load_file
            sd = load_file(os.path.join(path, "model.safetensors"))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        cfg = _config_from_state_dict(
            {k[4:] if k.startswith("esm.") else k: v for k, v in sd.items()},
            num_heads)
    model = Esm2Model(cfg)
    load_esm_state_dict(model, sd)
    return model.eval()
