"""The port's text frontend against the JAX package's on the CPU: the rule
G2Ps (English and Romanian, numbers, punctuation), the IDs and
sequence_to_text, split_sentences, the espeak wrapper against a stub
binary (tests/test_espeak.py's pattern), get_phonemizer's fallback, and
`cli inference` from graphemes on a tiny checkpoint. The IPA strings and
the IDs are equal."""

import json
import os
import shutil
import stat
import wave

import numpy as np
import pytest
import torch

from tests.test_torch_port_tts import TINY
from unitspeech_tpu import text as jtext
from unitspeech_tpu.text import g2p as jg2p
from unitspeech_tpu.text import g2p_ro as jg2p_ro
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch import text as ttext
from unitspeech_tpu_torch.config import config_from_dict
from unitspeech_tpu_torch.text import g2p as tg2p
from unitspeech_tpu_torch.text import g2p_ro as tg2p_ro

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

EN = [
    "Hello world, this is a test.",
    "The 3 quick brown foxes jumped over 1,024 lazy dogs; 2.5 times, on the 21st!",
    "«Wait...» really? Yes — it's 12:45, isn't it?",
    "Dr. Smith paid $19.99 for 1000000 books in 1999.",
    "through though thought tough cough bough rough, ought.",
]
RO = [
    "Bună ziua, ce mai faci?",
    "Am 21 de pisici și 1.000 de câini.",
    "Ștefan și Ioana merg la școală în fiecare zi!",
    "Acesta este un test: două sute douăzeci și unu.",
]
LONG = ("This is sentence one. Mr. Smith went to Washington. " + "word, " * 70
        + "end! And a question? Yes.")


@pytest.mark.parametrize("lang,text", [("en-us", t) for t in EN] + [("ro", t) for t in RO])
def test_rule_g2p_ipa_and_ids_equal_jax(lang, text):
    """Through the rule G2P of each language (what get_phonemizer gives
    without espeak), with and without stress: IPA, IDs and the IDs' text
    equal to JAX's."""
    cls = (tg2p_ro.RomanianG2P, jg2p_ro.RomanianG2P) if lang == "ro" else \
        (tg2p.RuleG2P, jg2p.RuleG2P)
    for stress in (True, False):
        got, want = (c(lang, with_stress=stress) for c in cls)
        assert ttext.phonemize(text, got) == jtext.phonemize(text, want)
        ids = ttext.text_to_sequence(text, got)
        assert ids == jtext.text_to_sequence(text, want)
        assert ttext.sequence_to_text(ids) == jtext.sequence_to_text(ids)
        assert ttext.text_to_sequence(text, got, add_blank=False) == \
            jtext.text_to_sequence(text, want, add_blank=False)


def test_number_expansion_and_words_equal_jax():
    for n in ("0", "7", "13", "100", "1,024", "3.14", "21st", "1999", "123456789012345"):
        assert tg2p.expand_numbers(n) == jg2p.expand_numbers(n)
        assert tg2p_ro.expand_numbers_ro(n) == jg2p_ro.expand_numbers_ro(n)
    for w in ("the", "phoneme", "xylophone", "queue", "knight"):
        assert tg2p.word_to_ipa(w) == jg2p.word_to_ipa(w)
    for w in ("lupi", "codri", "ziua", "chiar", "ghem"):
        assert tg2p_ro.word_to_ipa_ro(w) == jg2p_ro.word_to_ipa_ro(w)


@pytest.mark.parametrize("text", EN[:3] + [LONG, "", "   ", "One. Two"])
def test_split_sentences_equal_jax(text):
    for max_words in (60, 5):
        assert ttext.split_sentences(text, max_words) == jtext.split_sentences(text, max_words)


def test_phonemize_chunks_and_ipa_sequences_equal_jax():
    ipa = lambda s: s.upper()  # noqa: E731
    for text in ('«Wait...» really?', "...", "a, b", " lead. trail "):
        for keep in (True, False):
            for strip in (True, False):
                assert ttext.phonemize_chunks(ipa, text, keep, strip) == \
                    jtext.phonemize_chunks(ipa, text, keep, strip)
    s = "həloʊ wɜːld, ðɪs ɪz ɐ tˈɛst!"
    assert ttext.phonemes_to_sequence(s) == jtext.phonemes_to_sequence(s)


def _stub(tmp_path, monkeypatch, body):
    stub = tmp_path / "espeak-ng"
    stub.write_text("#!/usr/bin/env python3\nimport sys\n" + body)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")


@pytest.mark.parametrize("body", [
    "print('h\\u0259lo\\u028a t\\u0361\\u0283')\n",  # a tie to strip
    "print(sys.argv[-1])\n",  # echo: punctuation re-attachment shows
    "print('h\\u0259lo\\u028a (en)w\\u025c\\u02d0ld')\n",  # a language-switch flag
], ids=["tie", "echo", "flag"])
def test_espeak_wrapper_equal_jax_with_a_stub(tmp_path, monkeypatch, body):
    """The espeak backend against a stub espeak-ng: the same calls, IPA and
    IDs as JAX's, both languages."""
    _stub(tmp_path, monkeypatch, body)
    for lang in ("en-us", "ro"):
        got, want = ttext.get_phonemizer(lang), jtext.get_phonemizer(lang)
        assert isinstance(got, ttext.EspeakPhonemizer)
        for text in ("Hello, world. Bye!", '«Wait...» really?', "Bună ziua, 21 de pisici."):
            assert ttext.phonemize(text, got) == jtext.phonemize(text, want)
            assert ttext.text_to_sequence(text, got) == jtext.text_to_sequence(text, want)
        nostress = ttext.EspeakPhonemizer(lang, with_stress=False)
        assert ttext.phonemize("x", nostress) == jtext.phonemize(
            "x", jtext.EspeakPhonemizer(lang, with_stress=False))


def test_get_phonemizer_fallback_equal_jax(monkeypatch):
    """Without espeak: None, or with fallback=True the rule G2P of the
    language (None for one without rules); an unsupported language raises
    unless fallback is set, as in JAX."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for lang in ("en-us", "ro", "de"):
        if lang != "de":
            assert ttext.get_phonemizer(lang, fallback=False) is None
        got, want = ttext.get_phonemizer(lang, fallback=True), \
            jtext.get_phonemizer(lang, fallback=True)
        assert type(got).__name__ == type(want).__name__
    with pytest.raises(ValueError):
        ttext.get_phonemizer("de")
    with pytest.raises(ValueError):
        jtext.get_phonemizer("de")


@pytest.fixture
def tiny_ckpt(tmp_path):
    cfg = json.loads(json.dumps(TINY))
    cfg["text_encoder"]["n_vocab"] = 180  # the symbol table
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    ckpt = str(tmp_path / "ckpt.pt")
    cli.main_make_random_checkpoint(["--seed", "3", "--config", str(tmp_path / "tiny.json"),
                                     "--output", ckpt])
    return ckpt


def test_cli_inference_from_graphemes(tmp_path, tiny_ckpt, monkeypatch):
    """`cli inference --text` (graphemes, no espeak: the rule G2P): the
    tokens JAX's frontend gives; --split-sentences synthesizes one chunk a
    sentence, concatenated, each chunk with its own seed; --save-plot
    writes a PNG; --frames forces each chunk's length; --language ro takes
    the Romanian rules, and a language without rules exits as JAX does."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    base = ["--checkpoint", tiny_ckpt, "--device", "cpu", "--diffusion-steps", "2"]
    text = "Hello world, 42 cats. A second sentence here!"
    one = cli.main_inference(["--text", text, "--output", str(tmp_path / "a.wav"), *base])
    ph = jtext.get_phonemizer("en-us", fallback=True)
    assert one["chunks"] == 1 and one["tokens"] == len(jtext.text_to_sequence(text, ph))
    split = cli.main_inference(["--text", text, "--split-sentences", "--output",
                                str(tmp_path / "b.wav"), "--save-plot",
                                str(tmp_path / "mel.png"), *base])
    chunks = [jtext.text_to_sequence(c, ph) for c in jtext.split_sentences(text)]
    assert split["chunks"] == 2 and split["tokens"] == sum(map(len, chunks))
    assert (tmp_path / "mel.png").stat().st_size > 0
    with wave.open(str(tmp_path / "b.wav"), "rb") as w:
        hop = config_from_dict(TINY).data.hop_length
        assert split["frames"] == w.getnframes() // hop and w.getnframes() > 0
    assert cli.chunk_seed(42, 0) != cli.chunk_seed(42, 1) != cli.chunk_seed(43, 1)
    ro = cli.main_inference(["--text", "Bună ziua, 21 de pisici.", "--language", "ro",
                             "--output", str(tmp_path / "c.wav"), *base])
    assert ro["tokens"] == len(jtext.text_to_sequence(
        "Bună ziua, 21 de pisici.", jtext.get_phonemizer("ro", fallback=True)))
    with pytest.raises(SystemExit, match="no G2P fallback for 'de'"):
        cli.main_inference(["--text", "Hallo", "--language", "de", *base])
    forced = cli.main_inference(["--text", text, "--split-sentences", "--frames", "40",
                                 "--output", str(tmp_path / "d.wav"), *base])
    assert forced["chunks"] == 2 and forced["frames"] == 80


def test_cli_save_plot_without_matplotlib_exits(tmp_path, tiny_ckpt, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        cli.main_inference(["--ipa", "--text", "həloʊ", "--checkpoint", tiny_ckpt, "--device",
                            "cpu", "--save-plot", str(tmp_path / "m.png")])
    assert not np.any([p.suffix == ".png" for p in tmp_path.iterdir()])
