"""The port's sequence engine (PyTorch, on the CPU) against the JAX package's.

Weights are drawn by JAX's ``transformer_init`` and carried across by
``models/sequence/convert.py``; tokens and sessions are made with numpy
from a seed. Small shapes: d_model 16-32, 1-2 layers, windows of 8-40.
Tolerances: hidden states and logits rtol 1e-4 (both sides f32, sums in
other orders); top-k ids equal except among near-ties; the fit loop's
per-epoch losses rtol 1e-4 over 3 epochs and the trained weights within
1e-3 of max|w| (Adam divides by the gradient's running norm, which
magnifies last-digit differences of small gradients).
"""

import functools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_predictionio_tpu.models.sequence import engine as jseq
from incubator_predictionio_tpu.ops import transformer as jtr
from incubator_predictionio_tpu.ops.pallas_kernels import (
    flash_attention as jflash,
)
from incubator_predictionio_tpu.parallel.context import (
    RuntimeContext as JContext,
)
from incubator_predictionio_tpu.utils import json_codec as jcodec
from incubator_predictionio_tpu_torch.core import base as tbase
from incubator_predictionio_tpu_torch.core.engine import Engine
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.models.sequence import convert
from incubator_predictionio_tpu_torch.models.sequence import engine as tseq
from incubator_predictionio_tpu_torch.ops import attention_kernels as tfa
from incubator_predictionio_tpu_torch.ops import transformer as ttr
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext
from incubator_predictionio_tpu_torch.servers.prediction_server import (
    PredictionServer,
)
from incubator_predictionio_tpu_torch.utils import json_codec as tcodec
from incubator_predictionio_tpu_torch.utils.planted import (
    planted_sessions,
    random_transformer_fields,
)

CPU = "cpu"
RTOL = 1e-4


def _jax_fields(seed, n_items, max_len, d_model, n_layers):
    w = jtr.transformer_init(jax.random.key(seed), n_items, max_len,
                             d_model, n_layers)
    return {f: np.asarray(getattr(w, f)) for f in convert.FIELDS}


def _jax_weights(fields):
    return jtr.TransformerWeights(**{f: jnp.asarray(a)
                                     for f, a in fields.items()})


def _tokens(seed, b, l, n_items, pad_upto=None):
    """[b, l] int32 item tokens, row r left-padded with PAD up to
    ``pad_upto[r]``."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, n_items + 1, (b, l)).astype(np.int32)
    for r, p in enumerate(pad_upto or ()):
        tok[r, :p] = 0
    return tok


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# (d_model, n_heads, n_layers, window, pads); d_model 256 in one head is
# the head width of the flash kernel's wide form
SHAPES = [(16, 2, 1, 8, [0, 3]), (32, 2, 2, 40, [0, 39, 17]),
          (32, 4, 2, 24, [12]), (256, 1, 2, 16, [0, 11])]


@pytest.mark.parametrize("route", ["routed", "flash"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"d{s[0]}l{s[3]}")
def test_transformer_apply_and_logits_match_jax(route, shape):
    d, h, n_layers, l, pads = shape
    fields = _jax_fields(l, 50, l, d, n_layers)
    tok = _tokens(l + d, len(pads), l, 50, pads)
    if route == "flash":
        jattn = functools.partial(jflash, interpret=True, q_block=8,
                                  kv_block=8)
        tattn = functools.partial(tfa.flash_attention, kv_block=8)
    else:
        jattn = tattn = None
    jw = _jax_weights(fields)
    tw = convert.transformer_weights_from_numpy(fields, device=CPU)
    ref_h = jtr.transformer_apply(jw, jnp.asarray(tok), h, jattn)
    got_h = ttr.transformer_apply(tw, torch.from_numpy(tok), h, tattn)
    _close(got_h.numpy(), ref_h)
    ref_l = jtr.next_item_logits(jw, jnp.asarray(tok), h, jattn)
    got_l = ttr.next_item_logits(tw, torch.from_numpy(tok), h, tattn)
    _close(got_l.detach().numpy(), ref_l)


def test_routing_ladder_is_the_jax_packages(monkeypatch):
    """Dense up to 1,024, blockwise below FLASH_MIN_SEQ, flash from it up:
    with FLASH_MIN_SEQ lowered to 16 in both packages, a 24-long window
    takes the flash route in the port (the plain version on the CPU) and
    JAX's blockwise scan (its flash kernel is unavailable on the CPU)."""
    fields = _jax_fields(1, 30, 24, 16, 1)
    tok = _tokens(2, 2, 24, 30, [0, 10])
    calls = []
    real = ttr.flash_attention
    monkeypatch.setattr(ttr, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(ttr, "FLASH_MIN_SEQ", 16)
    monkeypatch.setattr(jtr, "FLASH_MIN_SEQ", 16)
    ref = jtr.transformer_apply(_jax_weights(fields), jnp.asarray(tok), 2)
    got = ttr.transformer_apply(
        convert.transformer_weights_from_numpy(fields, device=CPU),
        torch.from_numpy(tok), 2)
    assert len(calls) == 1
    _close(got.numpy(), ref)
    monkeypatch.setattr(ttr, "FLASH_MIN_SEQ", 25)
    ttr.transformer_apply(
        convert.transformer_weights_from_numpy(fields, device=CPU),
        torch.from_numpy(tok), 2)
    assert len(calls) == 1


def _assert_topk_alike(got_s, got_i, ref_s, ref_i, rtol=RTOL):
    """Scores agree; ids agree except where the reference's neighbouring
    scores are a near-tie."""
    got_s, ref_s = np.asarray(got_s, np.float64), np.asarray(ref_s,
                                                             np.float64)
    got_i, ref_i = np.asarray(got_i), np.asarray(ref_i)
    live = np.isfinite(ref_s)
    assert np.array_equal(np.isfinite(got_s), live)
    tol = rtol * np.abs(ref_s[live]).max()
    np.testing.assert_allclose(got_s[live], ref_s[live], rtol=rtol, atol=tol)
    for b, p in zip(*np.nonzero((got_i != ref_i) & live)):
        near = [q for q in (p - 1, p + 1) if 0 <= q < ref_s.shape[1]
                and abs(ref_s[b, q] - ref_s[b, p]) <= 2 * tol]
        assert near, (b, p, got_i[b, p], ref_i[b, p])


@pytest.mark.parametrize("d_model,n_heads", [(32, 2), (256, 1)],
                         ids=["d32", "head256"])
@pytest.mark.parametrize("k", [5, 51])
def test_sasrec_topk_matches_jax(k, d_model, n_heads):
    """PAD and every history token excluded; k above the live count leaves
    -inf slots, as lax.top_k does. Also at one head of 256 (the flash
    kernel's wide form): scores within RTOL of the JAX engine's."""
    fields = _jax_fields(3, 50, 16, d_model, 2)
    tok = _tokens(4, 3, 16, 50, [0, 12, 15])
    ref_s, ref_i = jtr.sasrec_topk(_jax_weights(fields), jnp.asarray(tok),
                                   n_heads, k=k)
    got_s, got_i = ttr.sasrec_topk(
        convert.transformer_weights_from_numpy(fields, device=CPU),
        torch.from_numpy(tok), n_heads, k=k)
    _assert_topk_alike(got_s.numpy(), got_i.numpy(), ref_s, ref_i)
    for r in range(3):
        assert not set(got_i[r][torch.isfinite(got_s[r])].tolist()) & (
            set(tok[r].tolist()) | {0})


def _jax_init(monkeypatch, fields):
    """The port's ``transformer_init`` made to return JAX's weights."""
    monkeypatch.setattr(ttr, "transformer_init",
                        lambda gen, *a, device=None, **k:
                        convert.transformer_weights_from_numpy(fields,
                                                               device))


def test_fit_loop_matches_jax_from_jax_init(monkeypatch):
    """sasrec_fit from JAX-initialised weights on the cyclic sessions: the
    same pre-batching (padding rows, seeded permutation), masked
    cross-entropy and AdamW (optax's defaults) as JAX's _fit_scan."""
    n_items, length, seed = 12, 9, 5
    seqs = planted_sessions(n_items, 40, length, seed=0)
    seqs[::7, :3] = 0                       # some left-padded sessions
    jw, jlosses = jtr.sasrec_fit(seqs, n_items=n_items, d_model=16,
                                 n_heads=2, n_layers=2, epochs=3,
                                 batch_size=16, learning_rate=3e-3,
                                 seed=seed)
    _jax_init(monkeypatch, _jax_fields(seed, n_items, length, 16, 2))
    stats = {}
    tw, tlosses = ttr.sasrec_fit(seqs, n_items=n_items, d_model=16,
                                 n_heads=2, n_layers=2, epochs=3,
                                 batch_size=16, learning_rate=3e-3,
                                 seed=seed, device=CPU, stats=stats)
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    assert stats["step_losses"].shape == (3, 3)
    np.testing.assert_allclose(stats["step_losses"].mean(axis=1), tlosses,
                               rtol=1e-6)
    assert tlosses[-1] < tlosses[0]
    for f in convert.FIELDS:
        ref = np.asarray(getattr(jw, f))
        got = getattr(tw, f).numpy()
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), f


def test_fit_with_the_flash_route_matches_the_routed_one():
    """Training through flash_attention (its autograd Function: the plain
    forward on the CPU, the blockwise recompute backward) follows the
    routed dense attention from the same seeded initial weights."""
    seqs = planted_sessions(10, 16, 9, seed=1)
    kw = dict(n_items=10, d_model=16, n_heads=2, n_layers=1, epochs=2,
              batch_size=8, learning_rate=3e-3, seed=0, device=CPU)
    w_dense, l_dense = ttr.sasrec_fit(seqs, **kw)
    w_flash, l_flash = ttr.sasrec_fit(
        seqs, attn_fn=functools.partial(tfa.flash_attention, kv_block=4),
        **kw)
    np.testing.assert_allclose(l_flash, l_dense, rtol=1e-5)
    _close(w_flash.item_emb.numpy(), w_dense.item_emb.numpy(), rtol=1e-4)


def test_planted_sessions_follow_the_cycle():
    s = planted_sessions(7, 20, 12, seed=3)
    assert s.shape == (20, 12) and s.dtype == np.int32
    assert s.min() >= 1 and s.max() <= 7
    np.testing.assert_array_equal(s[:, 1:], s[:, :-1] % 7 + 1)
    np.testing.assert_array_equal(s, planted_sessions(7, 20, 12, seed=3))


def test_random_transformer_fields_convert():
    fields = random_transformer_fields(30, 9, 16, 2, seed=4)
    w = convert.transformer_weights_from_numpy(fields, device=CPU)
    assert w.item_emb.shape == (31, 16) and w.w_up.shape == (2, 16, 64)
    assert w.item_emb.dtype == torch.float32
    with pytest.raises(ValueError, match="missing"):
        convert.transformer_weights_from_numpy(
            {k: v for k, v in fields.items() if k != "wq"}, device=CPU)
    with pytest.raises(ValueError, match="rows"):
        convert.seqrec_model_from_numpy(fields, ["a"] * 29, 2, 9,
                                        device=CPU)


def _sessions():
    """Cyclic sessions of string item ids, of uneven lengths."""
    seqs = planted_sessions(10, 24, 7, seed=2)
    return [[f"i{t - 1}" for t in row[: 4 + r % 4]]
            for r, row in enumerate(seqs)]


def test_preparator_matches_jax():
    sessions = _sessions()
    for max_len in (5, 8):
        ref = jseq.SequencePreparator(jseq.PreparatorParams(max_len=max_len)
                                      ).prepare(JContext(),
                                                jseq.TrainingData(sessions))
        got = tseq.SequencePreparator(tseq.PreparatorParams(max_len=max_len)
                                      ).prepare(RuntimeContext(device=CPU),
                                                tseq.TrainingData(sessions))
        np.testing.assert_array_equal(got.sequences, ref.sequences)
        assert dict(got.item_bimap.items()) == dict(ref.item_bimap.items())


TRAIN = dict(d_model=16, n_heads=2, n_layers=1, epochs=3, batch_size=8,
             learning_rate=3e-3, seed=0)
MAX_LEN = 8


@pytest.fixture(scope="module")
def trained_pair():
    """The same sessions and initial weights through the JAX preparator
    and algorithm and the port's ``Engine.train``."""
    sessions = _sessions()
    jpd = jseq.SequencePreparator(jseq.PreparatorParams(max_len=MAX_LEN)
                                  ).prepare(JContext(),
                                            jseq.TrainingData(sessions))
    jalgo = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(app_name="a",
                                                            **TRAIN))
    jmodel = jalgo.prepare_model(JContext(), jalgo.train(JContext(), jpd))
    fields = _jax_fields(TRAIN["seed"], len(jpd.item_bimap), MAX_LEN,
                         TRAIN["d_model"], TRAIN["n_layers"])

    class MemorySource(tbase.DataSource):
        def read_training(self, ctx):
            return tseq.TrainingData(sessions)

    eng = Engine(MemorySource, tseq.SequencePreparator,
                 {"sasrec": tseq.SeqRecAlgorithm}, tbase.FirstServing)
    ep = EngineParams(
        preparator_params=("", tseq.PreparatorParams(max_len=MAX_LEN)),
        algorithm_params_list=[("sasrec", tseq.SeqRecAlgorithmParams(
            app_name="a", **TRAIN))])
    mp = pytest.MonkeyPatch()
    try:
        _jax_init(mp, fields)
        [tmodel] = eng.train(RuntimeContext(device=CPU), ep)
    finally:
        mp.undo()
    return jalgo, jmodel, eng, ep, tmodel


def test_engine_train_matches_jax(trained_pair):
    _, jmodel, _, _, tmodel = trained_pair
    assert tmodel.max_len == jmodel.max_len == MAX_LEN
    assert dict(tmodel.item_bimap.items()) == dict(jmodel.item_bimap.items())
    np.testing.assert_allclose(tmodel.final_loss, jmodel.final_loss,
                               rtol=1e-4)
    assert tmodel.step_losses.shape == (TRAIN["epochs"], 3)
    for f in convert.FIELDS:
        ref = np.asarray(getattr(jmodel.weights, f))
        got = getattr(tmodel.weights, f).numpy()
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), f


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def server(trained_pair):
    _, _, eng, ep, tmodel = trained_pair
    srv = PredictionServer(eng, ep, [tmodel], device=CPU)
    port = srv.start_background()
    yield port
    srv.stop()


QUERIES = {
    "short": {"user": "u1", "num": 3, "recentItems": ["i2", "i3"]},
    "long": {"user": "u2", "num": 5,
             "recentItems": [f"i{j % 10}" for j in range(4, 15)]},
    "unknown_items": {"user": "u3", "num": 4,
                      "recentItems": ["nosuch", "i5"]},
    "whole_catalogue": {"user": "u4", "num": 20, "recentItems": ["i7"]},
    "no_known_item": {"user": "u5", "num": 4, "recentItems": ["nosuch"]},
    "num_zero": {"user": "u6", "num": 0, "recentItems": ["i1"]},
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_http_query_matches_jax(trained_pair, server, name):
    jalgo, jmodel, _, _, _ = trained_pair
    doc = QUERIES[name]
    status, got = _post(server, doc)
    assert status == 200
    ref = jcodec.to_jsonable(jalgo.predict(jmodel,
                                           jcodec.extract(jseq.Query, doc)))
    g, r = got["itemScores"], ref["itemScores"]
    assert len(g) == len(r)
    if not r:
        return
    ids = {s["item"]: i for i, s in
           enumerate(r)}  # item → rank in the reference
    _assert_topk_alike([[s["score"] for s in g]],
                       [[ids.get(s["item"], -1) for s in g]],
                       [[s["score"] for s in r]], [list(range(len(r)))],
                       rtol=1e-3)
    window = doc["recentItems"][-(MAX_LEN - 1):]   # the scoring window
    assert not {s["item"] for s in g} & set(window)


def test_query_extracts_recent_items():
    q = tcodec.extract(tseq.Query, {"user": "u", "num": 2,
                                    "recentItems": ["a", "b"]})
    assert q.recent_items == ("a", "b")
    assert tcodec.extract(tseq.Query, {"user": "u", "num": 2}
                          ).recent_items is None


@pytest.fixture
def tstore(tmp_path, monkeypatch):
    """The port's Storage on a fresh SQLite store under ``tmp_path``, with
    the app "a"."""
    from incubator_predictionio_tpu_torch.data.storage import App, Storage

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    Storage.reset()
    app_id = Storage.get_meta_data_apps().insert(App(0, "a"))
    Storage.get_events().init(app_id)
    yield Storage, app_id
    Storage.reset()


def _views(user, items, t0=0):
    from datetime import timedelta

    from incubator_predictionio_tpu_torch.data.event import Event
    from incubator_predictionio_tpu_torch.utils.times import parse_iso8601

    base = parse_iso8601("2024-01-01T00:00:00Z")
    return [Event(event="view", entity_type="user", entity_id=user,
                  target_entity_type="item", target_entity_id=i,
                  event_time=base + timedelta(seconds=t0 + k))
            for k, i in enumerate(items)]


def test_history_from_the_event_store_waits_for_storage(trained_pair,
                                                         server, tstore):
    """A query without ``recentItems`` is answered from the user's latest
    events in the store, as the same query with that history would be; a
    user with no events gets no items."""
    _, _, _, _, tmodel = trained_pair
    storage, app_id = tstore
    storage.get_events().insert_batch(
        _views("u1", ["i2", "i3"]) + _views("u2", ["i4"]), app_id)
    algo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(app_name="a"))
    ref = algo.predict(tmodel, tseq.Query(user="u1", num=3,
                                          recent_items=("i2", "i3")))
    assert len(ref.item_scores) == 3
    assert algo.predict(tmodel, tseq.Query(user="u1", num=3)) == ref
    assert algo.predict(tmodel, tseq.Query(user="u9", num=3)
                        ).item_scores == ()
    status, body = _post(server, {"user": "u1", "num": 3})
    assert status == 200
    assert body == tcodec.to_jsonable(ref)


def test_event_store_data_source_waits_for_storage(tstore):
    """The template's data source reads each user's view and buy events
    from the store, in event time, and drops sessions shorter than
    ``minSessionLength``; as the JAX data source does on the same
    events."""
    storage, app_id = tstore
    events = (_views("u1", ["i3", "i1", "i2"], t0=10) + _views("u2", ["i5"])
              + _views("u3", ["i2", "i4"], t0=5))
    events.reverse()   # stored out of time order
    storage.get_events().insert_batch(events, app_id)
    ds = tseq.SequenceDataSource(tseq.DataSourceParams(app_name="a"))
    td = ds.read_training(RuntimeContext(device=CPU))
    assert sorted(td.sessions) == [["i2", "i4"], ["i3", "i1", "i2"]]
    eng = tseq.SequenceEngine().apply()
    [model] = eng.train(RuntimeContext(device=CPU), EngineParams(
        data_source_params=("", tseq.DataSourceParams(app_name="a")),
        preparator_params=("", tseq.PreparatorParams(max_len=4)),
        algorithm_params_list=[("sasrec", tseq.SeqRecAlgorithmParams(
            app_name="a", d_model=8, epochs=1, seed=0))]))
    assert sorted(model.item_bimap) == ["i1", "i2", "i3", "i4"]


def test_seq_parallel_waits_for_multi_device():
    pd = tseq.SequencePreparator(tseq.PreparatorParams(max_len=6)).prepare(
        RuntimeContext(device=CPU), tseq.TrainingData(_sessions()))
    for mode, exc in (("ring", NotImplementedError),
                      ("ulysses", NotImplementedError), ("bogus", ValueError)):
        algo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(
            app_name="a", seq_parallel=mode, epochs=1, d_model=8))
        with pytest.raises(exc):
            algo.train(RuntimeContext(device=CPU), pd)


def test_empty_training_data_fails_the_sanity_check():
    with pytest.raises(ValueError, match="no usable sessions"):
        tseq.TrainingData([]).sanity_check()


def test_prepare_model_and_warmup(trained_pair):
    _, _, _, _, tmodel = trained_pair
    algo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(app_name="a"))
    raw = tseq.SeqRecModel(
        weights=tmodel.weights.map(lambda t: t.double().numpy()),
        item_bimap=tmodel.item_bimap, n_heads=2, max_len=MAX_LEN,
        final_loss=0.0)
    model = algo.prepare_model(RuntimeContext(device=CPU), raw)
    assert model.weights.wq.dtype == torch.float32
    algo.warmup(model)
    got = algo.predict(model, tseq.Query(user="u", num=3,
                                         recent_items=("i1",)))
    assert len(got.item_scores) == 3
