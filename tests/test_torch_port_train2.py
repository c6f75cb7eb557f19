"""STEP2 training and the unit-side preprocessors in the port against the
JAX package on the CPU: step2_loss, the unit encoder's gradients through
the frozen decoder, one make_step2_train_step step (the decoder frozen:
no gradient, parameters bit-unchanged, outside the optimizer), the units
dataset and its batches, `cli make-filelist` on the three corpus layouts,
`cli preprocess-spk-embs` and `preprocess-units` against JAX's CLIs (two
filelists, --max-files), `cli train-step2` with --resume into `cli
finetune --unit-encoder`, and an overfit run.

The JAX PRNG streams cannot be reproduced in torch, so the port is fed
JAX's draws, taken from the key JAX's step2_loss splits (k_drop, k_crop,
k_diff): the unit encoder's dropout masks (captured from flax's
nn.Dropout, tests/test_torch_port_train.py `_masked`), the crop's u and the
diffusion t and z. The modules are tiny (unit encoder 16 channels, decoder
dim 8, mults (1, 2)), in f32."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_port import randomize
from tests.test_torch_port_train import O0, TINY_TRAIN, _masked
from unitspeech_tpu import cli as jcli
from unitspeech_tpu.data import dataset as jdata
from unitspeech_tpu.models.diffusion import UnitSpeech as JUnitSpeech
from unitspeech_tpu.models.encoder import Encoder as JEncoder
from unitspeech_tpu.train import steps as jsteps
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import load_json
from unitspeech_tpu_torch.data import dataset as tdata
from unitspeech_tpu_torch.models.diffusion import UnitSpeech
from unitspeech_tpu_torch.models.encoder import Encoder
from unitspeech_tpu_torch.tools import synthetic_corpus
from unitspeech_tpu_torch.train import steps as tsteps
from unitspeech_tpu_torch.utils import artifacts
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

N_FEATS, SPK, B, TX, TY, SEG, LR, VOCAB = 16, 8, 4, 8, 24, 16, 1e-3, 20
UE = dict(n_vocab=VOCAB, n_feats=N_FEATS, n_channels=16, filter_channels=32, n_heads=2,
          n_layers=1, kernel_size=3, p_dropout=0.1, window_size=4)
DEC = dict(n_feats=N_FEATS, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=SPK)
# the tiny configuration of the CLIs: STEP1's, with a unit encoder and the
# SSL test models at 3.2 kHz (the 1.6 kHz wavs are resampled for them)
TINY2 = dict(TINY_TRAIN, unit_encoder={k: v for k, v in UE.items() if k != "window_size"},
             spk_embedder=dict(sr=3200, feat_type="wavlm_test", channels=16, spk_emb_dim=SPK),
             unit_extractor=dict(dense_model_name="hubert-test", sr=3200, vocab_size=VOCAB,
                                 hubert_layer=2),
             train=dict(TINY_TRAIN["train"], batch_size=2))
WORDS = ("ðə", "kwɪk", "bɹaʊn", "fɑks", "dʒʌmpt", "oʊvɚ", "leɪzi", "dɑɡ")


# --- the modules and JAX's draws -------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """The JAX unit encoder and decoder, their parameters (redrawn so that no
    branch is zero; small rezero gates), one units batch, and a jitted
    function that gives step2_loss's draws from a key."""
    ue, dec = JEncoder(**UE), JUnitSpeech(**DEC)

    def init_all(key):
        k1, k2 = jax.random.split(key)
        return {"unit_encoder": ue.init(k1, jnp.zeros((1, 6), jnp.int32), jnp.array([6])),
                "decoder": dec.init(k2, jnp.zeros((1, 8, N_FEATS)), jnp.ones((1, 8)),
                                    jnp.zeros((1, 8, N_FEATS)), jnp.zeros((1,)),
                                    jnp.zeros((1, SPK)))}

    key = jax.random.PRNGKey(0)
    init = jax.jit(init_all).lower(key).compile(**O0)(key)
    params = {k: randomize(v, i + 11) for i, (k, v) in enumerate(init.items())}
    params["decoder"] = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 0.1 if str(getattr(p[-1], "key", "")) == "g" else x, params["decoder"])
    rng = np.random.default_rng(1)
    lengths = np.array([TX, TX - 2, TX - 1, TX - 3], np.int32)
    durations = rng.integers(1, 4, (B, TX)).astype(np.float32)
    durations[np.arange(TX)[None, :] >= lengths[:, None]] = 0
    batch = {"units": rng.integers(0, VOCAB, (B, TX)).astype(np.int32),
             "unit_lengths": lengths, "durations": durations,
             "mel": rng.uniform(-1, 1, (B, TY, N_FEATS)).astype(np.float32),
             "mel_lengths": np.minimum(durations.sum(1), TY).astype(np.int32),
             "spk_emb": rng.standard_normal((B, SPK)).astype(np.float32)}

    def draws(p, bt, key):
        """JAX step2_loss's draws from `key`, in its split order."""
        k_drop, k_crop, k_diff = jax.random.split(key, 3)
        key_t, key_z = jax.random.split(k_diff)
        masks, _ = _masked(ue, p, bt["units"], bt["unit_lengths"], key=k_drop)
        return {"ue": masks, "u": jax.random.uniform(k_crop, (B,)),
                "t": jax.random.uniform(key_t, (B,)),
                "z": jax.random.normal(key_z, (B, SEG, N_FEATS))}

    return {"mods": (ue, dec), "params": jax.device_get(params), "batch": batch,
            "draws": draws}


def _torch(x):
    x = np.asarray(x)
    t = torch.from_numpy(np.array(x))
    return t.long() if x.dtype.kind == "i" else t


def _torch_draws(d):
    d = jax.device_get(d)
    return {**{k: _torch(v) for k, v in d.items() if k != "ue"},
            "ue": [_torch(m) for m in d["ue"]]}


def _port(params):
    ue, dec = Encoder(**UE), UnitSpeech(**DEC)
    ue.load_state_dict(params_from_jax(params["unit_encoder"]))
    dec.load_state_dict(params_from_jax(params["decoder"]))
    return ue, dec


@pytest.fixture(scope="module")
def jax_step(setup):
    """One STEP2 step of JAX's make_step2_train_step (Adam at LR, the clip
    of 5) with its draws (taken from the same key in the same compiled
    program), its metrics, the parameters after it, and JAX's gradient of
    step2_loss at the parameters before it."""
    s = setup
    ue, dec = s["mods"]
    opt = optax.adam(LR)
    step = jsteps.make_step2_train_step(ue, dec, opt, out_size=SEG)
    p = jax.tree_util.tree_map(jnp.asarray, s["params"])
    state = jsteps.TrainState(p["unit_encoder"], opt.init(p["unit_encoder"]), jnp.array(0))
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    key = jax.random.PRNGKey(5)

    def run(st, dp, b, k):
        grads = jax.grad(lambda up: jsteps.step2_loss(up, dp, b, k, ue, dec, SEG)[0])(st.params)
        return s["draws"](st.params, b, k), grads, step(st, dp, b, k)

    run = jax.jit(run).lower(state, p["decoder"], jb, key).compile(**O0)
    d, grads, (state, m) = run(state, p["decoder"], jb, key)
    return {"draws": _torch_draws(d), "grads": params_from_jax(jax.device_get(grads)),
            "metrics": {k: float(v) for k, v in m.items()},
            "params": params_from_jax(jax.device_get(state.params))}


def test_step2_loss_matches_jax(setup, jax_step):
    """step2_loss in f32 with JAX's draws: the total and both parts within
    1e-5 relative of the losses JAX's step reports; the draws are the unit
    encoder's dropout masks (prenet 3, one layer 4), the crop's u, t, z."""
    draws = jax_step["draws"]
    assert len(draws["ue"]) == 3 + 4
    ue, dec = _port(setup["params"])
    batch = {k: _torch(v) for k, v in setup["batch"].items()}
    total, parts = tsteps.step2_loss(ue, dec, batch, SEG, draws=draws)
    want = jax_step["metrics"]
    np.testing.assert_allclose(total.item(), want["total_loss"], rtol=1e-5)
    assert set(parts) == {"prior_loss", "diff_loss"}
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), want[k], rtol=1e-5, err_msg=k)


def test_unit_encoder_gradients_reach_through_the_frozen_decoder(setup, jax_step):
    """The unit encoder's gradient of step2_loss (the decoder frozen as
    make_step2_train_step freezes it) within 1e-4 relative plus 1e-4 of the
    module's largest JAX gradient entry of JAX's (absolute: the attention's
    key biases, whose exact gradient is zero, carry rounding noise alone);
    the decoder gets no gradient. The diffusion loss's share of the
    gradient (total minus the prior loss's alone) is far above that bound,
    so a decoder run under no_grad, which leaves the prior loss's gradient
    alone, fails this test."""
    ue, dec = _port(setup["params"])
    dec.requires_grad_(False)
    batch = {k: _torch(v) for k, v in setup["batch"].items()}
    total, parts = tsteps.step2_loss(ue, dec, batch, SEG, draws=jax_step["draws"])
    total.backward()
    got = {k: p.grad.clone() for k, p in ue.named_parameters()}
    assert all(p.grad is None for p in dec.parameters())
    ue.zero_grad(set_to_none=True)
    _, parts = tsteps.step2_loss(ue, dec, batch, SEG, draws=jax_step["draws"])
    parts["prior_loss"].backward()
    prior_only = {k: p.grad for k, p in ue.named_parameters()}
    want = jax_step["grads"]
    assert set(got) == set(want)
    diff_share = 0.0
    bound = 1e-4 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=bound, err_msg=k)
        if prior_only[k] is not None:
            diff_share = max(diff_share, float(np.abs(w - prior_only[k].numpy()).max() / bound))
    assert diff_share > 100, diff_share


def test_one_step2_train_step_matches_jax(setup, jax_step):
    """One make_step2_train_step step with JAX's draws: the losses within
    1e-5 and the pre-clip norm within 1e-4 relative of JAX's; each unit
    encoder parameter after Adam within 2e-3 * lr (one part in 500 of the
    most Adam moves it) plus one f32 rounding of JAX's, except entries whose
    gradient is below 1e-3 of the module's RMS gradient (their Adam move's
    sign is a rounding coin toss), held to 2 * lr. The decoder: every .grad
    None, every parameter bit-unchanged, none of them in the optimizer."""
    ue, dec = _port(setup["params"])
    before = {k: v.clone() for k, v in dec.state_dict().items()}
    opt = torch.optim.Adam(ue.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = tsteps.make_step2_train_step(ue, dec, opt, SEG)
    got = step({k: _torch(v) for k, v in setup["batch"].items()}, draws=jax_step["draws"])
    for k, v in jax_step["metrics"].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-4 if k == "grad_norm" else 1e-5,
                                   err_msg=k)
    assert all(p.grad is None and not p.requires_grad for p in dec.parameters())
    for k, v in dec.state_dict().items():
        assert torch.equal(v, before[k]), k
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert not held & {id(p) for p in dec.parameters()}
    assert held == {id(p) for p in ue.parameters()}

    grads = jax_step["grads"]
    rms = np.sqrt(np.mean(np.concatenate([g.numpy().ravel() for g in grads.values()]) ** 2))
    for k, p in ue.named_parameters():
        g, w = p.detach().numpy(), jax_step["params"][k].numpy()
        tol = np.full(g.shape, 2e-3 * LR) + np.spacing(np.abs(w))
        tol[np.abs(grads[k].numpy()) < 1e-3 * rms] = 2 * LR
        assert np.all(np.abs(g - w) <= tol), (k, np.abs(g - w).max())


# --- the data ---------------------------------------------------------------


def _texts(n, seed=0, lo=1, hi=3):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi)))) + "." for _ in range(n)]


def _unit_sidecars(filelist, hop, seed=0):
    """Units and durations for every wav of the filelist, aligned with its
    text as tools.synthetic_corpus lays the audio out: one unit a
    character (its code modulo VOCAB), the wav's frames shared equally."""
    from unitspeech_tpu_torch.utils.audio import load_wav

    for path, text, _ in tdata.parse_filelist(filelist):
        frames = len(load_wav(path)[0]) // hop
        units = np.array([ord(c) % VOCAB for c in text], np.int32)
        edges = np.arange(len(units) + 1) * frames // len(units)
        np.savez(path.rsplit(".", 1)[0] + ".units.npz", units=units,
                 durations=np.diff(edges).astype(np.int64))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus2")
    (d / "tiny.json").write_text(json.dumps(TINY2))
    cfg = load_json(str(d / "tiny.json"))
    out = synthetic_corpus(str(d / "wavs"), cfg, _texts(8, seed=3), n_speakers=2,
                           seconds=(0.5, 1.2), seed=4)
    _unit_sidecars(out["filelist"], 16)
    return {**out, "dir": d, "config": str(d / "tiny.json"), "cfg": cfg}


def test_units_dataset_collator_and_batches_match_jax(corpus):
    """UnitMelSpeakerDataset (the sidecars) and BucketCollator's units form
    over two epochs of iterate_batches from one numpy generator: every
    array equal to JAX's, keys units / unit_lengths / durations; a sidecar
    whose two arrays differ in length, and a wav at another rate, raise."""
    fl = corpus["filelist"]
    jds = jdata.UnitMelSpeakerDataset(jdata.parse_filelist(fl), hop_length=16,
                                      sampling_rate=1600)
    tds = tdata.UnitMelSpeakerDataset(tdata.parse_filelist(fl), hop_length=16,
                                      sampling_rate=1600)
    assert len(tds) == len(jds) == 8
    jcol, tcol = jdata.BucketCollator(16, 1), tdata.BucketCollator(16, 1)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    n = 0
    for _ in range(2):
        for jb, tb in zip(jdata.iterate_batches(jds, jcol, 4, key=jrng),
                          tdata.iterate_batches(tds, tcol, 4, key=trng), strict=True):
            assert set(tb) == set(jb) == {"units", "unit_lengths", "durations", "wav",
                                          "mel_lengths", "spk_id"}
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
                assert tb[k].dtype == jb[k].dtype, k
            n += 1
    assert n == 4
    with pytest.raises(ValueError, match="1600"):
        tdata.UnitMelSpeakerDataset(tdata.parse_filelist(fl), sampling_rate=22050)[0]
    bad = tdata.parse_filelist(fl)[0][0].rsplit(".", 1)[0] + ".units.npz"
    good = dict(np.load(bad))
    try:
        np.savez(bad, units=good["units"], durations=good["durations"][:-1])
        with pytest.raises(ValueError, match="durations"):
            tds[0]
    finally:
        np.savez(bad, **good)


def _tree(root, layout):
    """A small corpus tree of `layout` (the files' contents do not matter to
    make-filelist, only their names and the texts)."""
    def touch(p, text=None):
        os.makedirs(os.path.dirname(p), exist_ok=True)
        open(p, "wb").close()
        if text is not None:
            with open(p, "w", encoding="utf-8") as fh:
                fh.write(text)

    if layout == "ljspeech":
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as fh:
            for i in range(12):
                fh.write(f"LJ001-{i:04d}|Raw text {i}.|Normalized text {i}.\n")
            fh.write("malformed\n")
        return
    for spk in ("19", "103", "spk_b"):
        for ch in ("1", "27"):
            for u in range(3):
                stem = (os.path.join(root, spk, ch, f"{spk}_{ch}_{u}") if layout == "libritts"
                        else os.path.join(root, spk, f"{ch}_{u}"))
                touch(stem + ".wav")
                if u == 0:
                    touch(stem + ".normalized.txt", f"normalized {spk} {ch}|{u}\n")
                    touch(stem + ".txt", "not this one")
                elif u == 1:
                    touch(stem + (".txt" if ch == "1" else ".lab"), f" text {spk} {ch} {u} ")
    touch(os.path.join(root, "19", "orphan.wav"))  # no text: skipped
    touch(os.path.join(root, "notes.txt"), "not a wav")


@pytest.mark.parametrize("layout", ["ljspeech", "libritts", "generic"])
def test_make_filelist_is_byte_identical_to_jax(tmp_path, layout):
    """`cli make-filelist` writes valid.txt, test.txt and train.txt
    byte-identical to JAX's for the same tree: with the default split
    sizes, and with --valid / --test / --seed and --speaker-ids."""
    root = str(tmp_path / "root")
    _tree(root, layout)
    for extra in ([], ["--valid", "3", "--test", "2", "--seed", "7", "--speaker-ids"]):
        args = ["--corpus", layout, "--root", root, *extra]
        assert jcli.main_make_filelist(args + ["--out-dir", str(tmp_path / "j")]) == 0
        splits = cli.main_make_filelist(args + ["--out-dir", str(tmp_path / "t")])
        assert sum(len(v) for v in splits.values()) == 12
        for name in ("valid", "test", "train"):
            want = (tmp_path / "j" / f"{name}.txt").read_bytes()
            assert (tmp_path / "t" / f"{name}.txt").read_bytes() == want, (layout, extra, name)
        assert len((tmp_path / "t" / "train.txt").read_bytes()) > 0
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "metadata.csv").write_text("")
    with pytest.raises(SystemExit, match="no utterances"):
        cli.main_make_filelist(["--corpus", layout, "--root", str(tmp_path / "empty"),
                                "--out-dir", str(tmp_path / "e")])


# --- the SSL preprocessors against JAX's CLIs ---------------------------------


@pytest.fixture(scope="module")
def two_filelists(corpus):
    """The corpus split into two filelists of four, and the SSL models at
    the test widths (random weights from a seed) in two files each: JAX's
    orbax checkpoint and the port's module file of the same weights (the
    k-means centroids one .npz)."""
    from unitspeech_tpu.config import load_json as jload_json
    from unitspeech_tpu.models import speaker as jsp
    from unitspeech_tpu.models.ssl import hubert as jh
    from unitspeech_tpu.utils.checkpoint import save_checkpoint

    d = corpus["dir"]
    lines = open(corpus["filelist"], encoding="utf-8").read().splitlines()
    out = []
    for i in range(2):
        p = d / f"part{i}.txt"
        p.write_text("\n".join(lines[4 * i:4 * i + 4]) + "\n")
        out.append(str(p))

    def variables(model, seed):
        v = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2000))), seed)
        return jax.device_get(jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.abs(x) + 0.5 if str(getattr(p[-1], "key", "")) == "var" else x, v))

    jcfg = jload_json(corpus["config"])
    spk = variables(jsp.SpeakerEmbedder.from_config(jcfg.spk_embedder), 40)
    hub = variables(jh.HubertModel(jh.hubert_test_config()), 41)
    files = {"jax": {"spk": save_checkpoint(str(d / "jspk"), 0, spk),
                     "hubert": save_checkpoint(str(d / "jhub"), 0, hub)},
             "port": {"spk": artifacts.save_module(str(d / "spk.pt"), "speaker_embedder",
                                                   params_from_jax(spk), corpus["cfg"]),
                      "hubert": artifacts.save_module(str(d / "hubert.pt"), "hubert",
                                                      params_from_jax(hub), corpus["cfg"])},
             "kmeans": str(d / "km.npz")}
    np.savez(files["kmeans"], centroids=np.random.default_rng(42).standard_normal(
        (VOCAB, 16)).astype(np.float32))
    return out, files


@pytest.mark.parametrize("bucket", [False, True])
def test_preprocess_spk_embs_matches_jax_cli(corpus, two_filelists, tmp_path, bucket):
    """`cli preprocess-spk-embs` over two filelists with --max-files 3
    (with and without --bucket-ssl) against JAX's command on the same
    weights: the same speakers, each mean within 1e-5 absolute
    plus 1e-4 relative. Both follow JAX's max_files: the first filelist
    stops at the third wav, the second adds one more (four in all)."""
    fls, files = two_filelists
    args = [x for f in fls for x in ("--filelist", f)] + [
        "--max-files", "3", "--config", corpus["config"]] + (["--bucket-ssl"] if bucket else [])
    jout, tout = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jcli.main_preprocess_spk_embs(args + ["--speaker-embedder", files["jax"]["spk"],
                                                 "--out", jout, "--cpu"]) == 0
    got = cli.main_preprocess_spk_embs(args + ["--speaker-embedder", files["port"]["spk"],
                                               "--out", tout, "--device", "cpu"])
    want = dict(np.load(jout))
    assert sorted(want) == sorted(np.load(tout).files) == [str(k) for k in sorted(got)]
    for k, v in want.items():
        np.testing.assert_allclose(got[int(k)], v, rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(np.load(tout)[k], got[int(k)])
    # the wavs it read: the first three of the first list, the first of the second
    read = [tdata.parse_filelist(fls[0])[i] for i in range(3)] + [tdata.parse_filelist(fls[1])[0]]
    assert sorted({int(r[2]) for r in read}) == sorted(got)


def test_preprocess_units_matches_jax_cli(corpus, two_filelists):
    """`cli preprocess-units` over two filelists with --max-files 3 against
    JAX's command on the same weights and centroids (the 1.6 kHz wavs
    resampled to 3.2 kHz on both sides): the same sidecars, written for the
    same wavs (three of the first list, one of the second: JAX's
    max_files), their units and durations equal."""
    fls, files = two_filelists
    rows = [r[0] for f in fls for r in tdata.parse_filelist(f)]
    saved = {p: dict(np.load(p.rsplit(".", 1)[0] + ".units.npz")) for p in rows}
    args = [x for f in fls for x in ("--filelist", f)] + [
        "--kmeans", files["kmeans"], "--max-files", "3", "--config", corpus["config"]]
    side = {p: p.rsplit(".", 1)[0] + ".units.npz" for p in rows}
    try:
        for p in rows:
            os.remove(side[p])
        assert jcli.main_preprocess_units(args + ["--hubert", files["jax"]["hubert"],
                                                  "--cpu"]) == 0
        want = {p: dict(np.load(side[p])) for p in rows if os.path.exists(side[p])}
        for p in want:
            os.remove(side[p])
        assert cli.main_preprocess_units(args + ["--hubert", files["port"]["hubert"],
                                                 "--device", "cpu"]) == 4
        got = {p: dict(np.load(side[p])) for p in rows if os.path.exists(side[p])}
    finally:
        for p, v in saved.items():
            np.savez(side[p], **v)
    assert sorted(got) == sorted(want) == sorted(rows[:3] + rows[4:5])
    for p in want:
        for k in ("units", "durations"):
            np.testing.assert_array_equal(got[p][k], want[p][k], err_msg=(p, k))
        assert len(got[p]["units"]) > 3


# --- the CLI and the overfit run ---------------------------------------------


def test_cli_train_step2_resume_then_finetune(corpus, tmp_path):
    """`cli train-step2` for one epoch on the CPU (the frozen decoder from a
    random checkpoint), then --resume for a second: it starts at epoch 1,
    step 4; its checkpoint holds the unit encoder and its Adam state alone
    (no decoder), and `cli finetune --unit-encoder` reads it."""
    cfgp, fl = corpus["config"], corpus["filelist"]
    ms, rand = str(tmp_path / "ms.npz"), str(tmp_path / "rand.pt")
    cli.main(["preprocess-mel-stats", "--filelist", fl, "--out", ms, "--config", cfgp,
              "--device", "cpu"])
    cli.main_make_random_checkpoint(["--config", cfgp, "--output", rand])
    flags = ["--filelist", fl, "--spk-embs", corpus["spk_embs"], "--mel-stats", ms,
             "--decoder", rand, "--config", cfgp, "--device", "cpu", "--checkpoint-dir",
             str(tmp_path / "ck"), "--log-dir", str(tmp_path / "log")]
    first = cli.main_train_step2(flags + ["--n-epochs", "1"])
    assert first["steps"] == 4 and first["checkpoint"].endswith("step_1")
    again = cli.main_train_step2(flags + ["--n-epochs", "2", "--resume"])
    assert (again["start_epoch"], again["first_step"], again["steps"]) == (1, 4, 8)
    assert all(np.isfinite(v) for m in first["metrics"] + again["metrics"] for v in m.values())
    assert set(first["metrics"][0]) == {"prior_loss", "diff_loss", "total_loss", "grad_norm"}
    ck = torch.load(again["checkpoint"], weights_only=True)
    assert "unit_encoder" in ck and "decoder" not in ck and ck["step"] == 8
    with torch.device("meta"):
        n_params = len(list(Encoder.from_config(corpus["cfg"].unit_encoder).parameters()))
    assert len(ck["opt_state"]["state"]) == n_params
    sd = artifacts.load_encoder_params(again["checkpoint"], corpus["cfg"].unit_encoder,
                                       "unit_encoder")
    assert all(torch.equal(sd[k], v) for k, v in ck["unit_encoder"].items())
    wav = tdata.parse_filelist(fl)[0][0]
    stats = cli.main_finetune(["--reference", wav, "--decoder", rand, "--unit-encoder",
                               again["checkpoint"], "--units",
                               wav.rsplit(".", 1)[0] + ".units.npz", "--output-dir",
                               str(tmp_path / "ad"), "--n-iters", "2", "--frame-buckets", "",
                               "--config", cfgp, "--device", "cpu"])
    assert np.isfinite(stats["losses"]).all() and os.path.exists(stats["output"])


def test_overfit_tiny_corpus(corpus, tmp_path):
    """Twenty STEP2 steps at lr 1e-3 on one batch of four utterances (units
    aligned with the audio), fixed seed, the decoder frozen: the prior loss
    and the total loss each drop (the mean of the last 10 steps below that
    of the first 10), and the decoder does not move."""
    cfgp, fl = corpus["config"], corpus["filelist"]
    ms, rand = str(tmp_path / "ms.npz"), str(tmp_path / "rand.pt")
    cli.main(["preprocess-mel-stats", "--filelist", fl, "--out", ms, "--config", cfgp,
              "--device", "cpu"])
    cli.main_make_random_checkpoint(["--config", cfgp, "--output", rand])
    args = cli.step2_parser().parse_args(
        ["--filelist", fl, "--spk-embs", corpus["spk_embs"], "--mel-stats", ms, "--decoder",
         rand, "--config", cfgp, "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
         "--log-dir", str(tmp_path / "log")])
    cfg, loop, decoder = cli.build_step2(args)
    assert loop.optimizer.param_groups[0]["lr"] == 1e-3
    before = {k: v.clone() for k, v in decoder.state_dict().items()}
    batch = loop._prepare_batch(loop.collator([loop.dataset[i] for i in range(4)]))
    gen = torch.Generator().manual_seed(0)
    hist = [{k: v.item() for k, v in loop.train_step(batch, gen).items()} for _ in range(20)]
    for k in ("prior_loss", "total_loss"):
        first, last = (np.mean([h[k] for h in hist[s]]) for s in (slice(0, 10), slice(-10, None)))
        assert last < first, (k, first, last)
    assert all(torch.equal(v, before[k]) for k, v in decoder.state_dict().items())
