"""The port's ESM2 encoder (fabind_tpu_torch.models.esm2) against the JAX
package's flax Esm2Model, on the CPU at toy width (hidden 32, 2 layers, 4
heads), and its HuggingFace state-dict loading.

The JAX weights move into the port through
`train.convert.esm_state_dict_from_flax`; the forward is held to JAX's on a
padded batch that holds a <mask> token, and `embed_sequences` to JAX's over
ragged lengths in two length buckets. The word embeddings are drawn at
unit scale, as a real checkpoint's stream is: at the init's 0.02 scale the
final LayerNorm amplifies rounding ~50x.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fabind_tpu.models import esm2 as JE

from fabind_tpu_torch.models import esm2 as E
from fabind_tpu_torch.train.convert import (esm_state_dict_from_flax,
                                            load_esm_state_dict)

TOY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
# fp32 forwards of the same function on two frameworks: reduction order only
ATOL = 1e-5
SEQS = ["LAGVSE", "KQNFAMWYHDLL", "AC", "GGAAVVLLKKMMW", "MKV", "WYHDKQX"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: its tensors are
    toy-sized, and the suite runs in parallel workers that would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    ids = np.full((2, 16), JE.PAD_ID, np.int32)
    ids[0, :12] = JE.tokenize("LAGVSERTIL")
    ids[1, :8] = JE.tokenize("KQNFAM")
    ids[1, 3] = JE.MASK_ID                  # exercises token dropout
    return ids, (ids != JE.PAD_ID).astype(np.int32)


@pytest.fixture(scope="module")
def toy():
    """The JAX model and its parameters (word embeddings at unit scale),
    and the port model with the same weights."""
    jmodel = JE.Esm2Model(JE.Esm2Config(**TOY))
    ids, mask = _batch()
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), ids, mask)
                     )()["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["word_embeddings"]["embedding"] = np.random.RandomState(
        0).randn(33, TOY["hidden_size"]).astype(np.float32)
    model = E.Esm2Model(E.Esm2Config(**TOY))
    assert load_esm_state_dict(model, esm_state_dict_from_flax(params)) == []
    return jmodel, params, model.eval()


def test_vocabulary_and_tokenizer_match_jax():
    assert E.ESM_VOCAB == JE.ESM_VOCAB
    assert (E.CLS_ID, E.PAD_ID, E.EOS_ID, E.UNK_ID, E.MASK_ID) == (
        JE.CLS_ID, JE.PAD_ID, JE.EOS_ID, JE.UNK_ID, JE.MASK_ID)
    for seq, pad in (("LAGVSEX", None), ("KQ", 8), ("", 4)):
        np.testing.assert_array_equal(E.tokenize(seq, pad),
                                      JE.tokenize(seq, pad))
    assert (dataclasses.asdict(E.Esm2Config())
            == dataclasses.asdict(JE.Esm2Config()))
    with pytest.raises(ValueError):
        E.tokenize("LAGV", pad_to=4)


def test_forward_matches_jax_on_padded_batch_with_mask(toy):
    jmodel, params, model = toy
    ids, mask = _batch()
    want = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, ids,
                                                     mask))(params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids.astype(np.int64)),
                    torch.from_numpy(mask)).numpy()
    for b in range(2):
        n = int(mask[b].sum())          # padded positions are don't-care
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL,
                                   rtol=0, err_msg=f"row {b}")


def test_embed_sequences_matches_jax_across_buckets(toy):
    """Ragged lengths in two buckets of pad_multiple 8 (lengths + 2 up to
    8 and 16), 2 rows per forward with the tails filled; in input order,
    <cls>/<eos> stripped, and a sequence alone equal to it in a batch."""
    jmodel, params, model = toy
    want = JE.embed_sequences(jmodel, params, SEQS, pad_multiple=8,
                              batch_size=2)
    got = model.embed_sequences(SEQS, pad_multiple=8, batch_size=2)
    assert [g.shape for g in got] == [(len(s), 32) for s in SEQS]
    for s, g, w in zip(SEQS, got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=s)
    alone = model.embed_sequences(SEQS[1:2], pad_multiple=8)[0]
    np.testing.assert_allclose(alone, got[1], atol=ATOL, rtol=0)


def test_state_dict_names_and_leftovers(toy):
    _, params, model = toy
    sd = esm_state_dict_from_flax(params)
    assert sorted(sd) == sorted(model.state_dict())
    extra = {"esm." + k: v for k, v in sd.items()}
    extra.update({"lm_head.dense.weight": torch.zeros(1),
                  "esm.contact_head.regression.weight": torch.zeros(1),
                  "esm.embeddings.position_ids": torch.zeros(1),
                  "esm.encoder.layer.0.attention.self.rotary_embeddings"
                  ".inv_freq": torch.zeros(1)})
    fresh = E.Esm2Model(E.Esm2Config(**TOY))
    assert len(load_esm_state_dict(fresh, extra)) == 4
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not know"):
        load_esm_state_dict(fresh, dict(sd, **{"encoder.extra": sd[
            "encoder.emb_layer_norm_after.bias"]}))
    with pytest.raises(RuntimeError, match="Missing"):
        load_esm_state_dict(fresh, {k: v for k, v in sd.items()
                                    if "layer.1." not in k})


def _hf_model(hidden=32, layers=2, heads=4, inter=64):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.EsmConfig(
        vocab_size=33, mask_token_id=32, pad_token_id=1,
        hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter,
        position_embedding_type="rotary", token_dropout=True,
        emb_layer_norm_before=False, layer_norm_eps=1e-5,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        attn_implementation="eager")
    torch.manual_seed(0)
    m = transformers.EsmForMaskedLM(cfg)
    with torch.no_grad():
        m.esm.embeddings.word_embeddings.weight.normal_(0, 1.0)
    return m.eval()


def test_huggingface_state_dict_loads_strict_and_matches(tmp_path):
    """An `EsmForMaskedLM` state dict (esm. prefix, LM head and buffers
    left over) loads strict; each sequence unpadded (HuggingFace's
    token-dropout rescale uses the padded length) matches HuggingFace's
    last hidden state in float64. `load_esm2` reads the same weights from
    a saved directory (config.json + pytorch_model.bin or
    model.safetensors) and from a bare state dict file."""
    hf = _hf_model().double()
    model = E.Esm2Model(E.Esm2Config(**TOY)).double()
    unused = load_esm_state_dict(model, hf.state_dict())
    assert unused and all(k.startswith(("lm_head.", "contact_head."))
                          or "inv_freq" in k or "position_ids" in k
                          for k in unused), unused
    bare = E.Esm2Model(E.Esm2Config(**TOY)).double()   # EsmModel's names
    load_esm_state_dict(bare, hf.esm.state_dict())
    for k, v in bare.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    ids = E.tokenize("LAGVSERTIL").astype(np.int64)
    ids[4] = E.MASK_ID
    for row in (ids, E.tokenize("KQNF").astype(np.int64)):
        t = torch.from_numpy(row)[None]
        with torch.no_grad():
            want = hf.esm(input_ids=t, attention_mask=torch.ones_like(t)
                          ).last_hidden_state[0].numpy()
            got = model(t, torch.ones_like(t))[0].numpy()
        # the JAX package's bound for this comparison (tests/test_esm2.py):
        # both build the rotary tables in float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    hf = hf.float()
    hf.save_pretrained(tmp_path / "hf", safe_serialization=False)
    hf.save_pretrained(tmp_path / "hf_safetensors", safe_serialization=True)
    torch.save(hf.state_dict(), tmp_path / "sd.pt")
    want = model.float().embed_sequences(SEQS[:3])
    for path in (tmp_path / "hf", tmp_path / "hf_safetensors",
                 tmp_path / "sd.pt"):
        loaded = E.load_esm2(str(path), num_heads=TOY["num_heads"])
        assert loaded.cfg == E.Esm2Config(**TOY)
        for g, w in zip(loaded.embed_sequences(SEQS[:3]), want):
            np.testing.assert_array_equal(g, w)
