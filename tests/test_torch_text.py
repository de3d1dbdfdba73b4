"""The port's open-vocabulary text machinery against the JAX reference on
the CPU: vocabularies, templates and merge matrices equal; the tokenizer's
ids equal in hash-fallback and BPE mode (a small merges file the test
learns and writes); `CLIPTextEncoder` within atol 1e-5 (fp32); the
classifier within atol 1e-5 of each unit row (before exp(logit_scale));
the text-tower loader strict on both sides."""

import collections
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import np_tree, perturbed, port_tiny_cfg, to_np

from veon_tpu.configs import presets as jpresets
from veon_tpu.nn import text as jtext
from veon_tpu.nn.vit import CLIPTextEncoder as JaxTextEncoder
from veon_tpu_torch.ckpt.from_jax import load_text_tower
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import build_text_tower
from veon_tpu_torch.nn import text as ptext
from veon_tpu_torch.nn.text import text_classifier
from veon_tpu_torch.nn.vit import CLIPTextEncoder

VOCABULARIES = ["nuscenes_brief", "nuscenes_default", "semkitti_brief", "coco_default"]

# prompts that stress the tokenizer: case, punctuation, contractions, html
# entities, runs of whitespace, digits, non-ASCII letters and symbols, the
# special tokens, and texts long enough to be cut at 77 tokens
TEXTS = [
    "a photo of a car.", "This is a photo of a LARGE traffic-cone", "",
    "  there's   a\tdog\n in the scene ", "it&#39;s &amp; 3 cars, 42 buses!",
    "café naïve Zürich – 北京 ü ☃ 🚗", "<|startoftext|>road<|endoftext|>",
    "hatch-back SUV mini-van jeep o'clock they'll we've I'm", " ".join(["wheelchair"] * 90),
    "police vehicle, in detail 'all types of police vehicles including police bicycles "
    "and motorcycles.' " * 4,
]


def _corpus():
    prompts = [p for v in VOCABULARIES for p in jtext.build_vocabulary(v)[0]]
    return TEXTS + prompts + [t.format(p) for t in jtext.VILD_TEMPLATES for p in prompts[:20]]


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    """A merges file learned from the test corpus (most frequent pair
    first, ties by the pair's order), in the format of CLIP's
    bpe_simple_vocab_16e6.txt.gz: a header line, then one merge per line."""
    tok = jtext.ClipTokenizer(None)
    words = collections.Counter()
    for text in _corpus():
        text = jtext._whitespace_clean(jtext._basic_clean(text)).lower()
        for w in jtext.re.findall(tok.pat, text):
            w = "".join(tok.byte_encoder[b] for b in w.encode("utf-8"))
            words[tuple(w[:-1]) + (w[-1] + "</w>",)] += 1
    merges = []
    for _ in range(300):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w[:-1], w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    path = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return str(path)


@pytest.mark.parametrize("name", VOCABULARIES)
def test_vocabulary_and_merge_matrix_match_reference(name):
    prompts, refl = ptext.build_vocabulary(name)
    want_p, want_r = jtext.build_vocabulary(name)
    assert (prompts, refl) == (want_p, want_r)
    for extra in (1, 2):
        np.testing.assert_array_equal(ptext.merge_matrix(refl, extra_rows=extra),
                                      jtext.merge_matrix(want_r, extra_rows=extra))


def test_unknown_vocabulary_raises():
    with pytest.raises(ValueError, match="unknown vocabulary"):
        ptext.build_vocabulary("kitti360")


@pytest.mark.parametrize("name", ["vild", "imagenet"])
def test_templates_match_reference(name):
    assert ptext.get_templates(name) == jtext.get_templates(name)


def test_text_config_matches_reference():
    for port, ref in ((presets.veon_b(), jpresets.veon_b()),
                      (presets.veon_tiny_test(), jpresets.veon_tiny_test())):
        for f in ("template_set", "text_width", "text_heads", "text_layers",
                  "text_context_length", "text_vocab_size", "clip_embed_dim"):
            assert getattr(port.san, f) == getattr(ref.san, f), f
        assert port.data.depth_norm_method == ref.data.depth_norm_method


@pytest.mark.parametrize("mode", ["fallback", "bpe"])
def test_tokenizer_ids_equal_reference(mode, bpe_file):
    path = bpe_file if mode == "bpe" else None
    port, ref = ptext.ClipTokenizer(path), jtext.ClipTokenizer(path)
    assert port.fallback == ref.fallback == (mode == "fallback")
    texts = _corpus()
    for t in texts:
        assert port.encode(t) == ref.encode(t), t
    got, want = port.tokenize(texts), ref.tokenize(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, want)
    cut = got[TEXTS.index(" ".join(["wheelchair"] * 90))]
    assert cut[0] == 49406 and cut[-1] == 49407  # truncated: EOT kept last
    if mode == "bpe":  # the merges took effect: fewer ids than bytes
        assert len(port.encode("construction vehicle")) < len("construction vehicle")


@pytest.fixture(scope="module")
def tiny_tower():
    """The tiny preset's JAX text tower with perturbed params, and tokens
    of prompts of every length (one cut at 77)."""
    cfg = jpresets.veon_tiny_test()
    s = cfg.san
    enc = JaxTextEncoder(width=s.text_width, heads=s.text_heads, num_layers=s.text_layers,
                         out_dim=s.clip_embed_dim, vocab_size=s.text_vocab_size,
                         context_length=s.text_context_length)
    params = perturbed(enc.init(jax.random.PRNGKey(1), jnp.zeros((1, 77), jnp.int32)), seed=4)
    return cfg, enc, params


def test_text_encoder_matches_reference(tiny_tower):
    cfg, enc, params = tiny_tower
    tokens = jtext.ClipTokenizer(None).tokenize(TEXTS)
    want = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(tokens)))
    tower = build_text_tower(port_tiny_cfg(), "cpu", params=params["params"])
    got = to_np(tower(torch.from_numpy(tokens)))
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), cfg.san.clip_embed_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", ["fallback", "bpe"])
def test_text_classifier_matches_reference(tiny_tower, bpe_file, mode):
    from veon_tpu.cli.main import _text_classifier

    cfg, _enc, params = tiny_tower
    path = bpe_file if mode == "bpe" else None
    rng = np.random.default_rng(5)
    C = cfg.san.clip_embed_dim
    extras = {"text_tower": np_tree(params["params"]),
              "bg_embed": rng.standard_normal((1, C)).astype(np.float32),
              "logit_scale": np.float32(np.log(1 / 0.07))}
    for vocab in ("nuscenes_brief", "nuscenes_default"):
        prompts, _ = jtext.build_vocabulary(vocab)
        want, _, _ = _text_classifier(cfg, prompts, extras, bpe_path=path, require_bpe=False)
        tower = build_text_tower(port_tiny_cfg(), "cpu", params=extras["text_tower"])
        got = text_classifier(port_tiny_cfg(), prompts, tower, extras["bg_embed"],
                              extras["logit_scale"], bpe_path=path, require_bpe=False)
        assert got.dtype == torch.float32 and tuple(got.shape) == (len(prompts) + 1, C)
        scale = float(np.exp(extras["logit_scale"]))
        np.testing.assert_allclose(to_np(got) / scale, np.asarray(want) / scale, rtol=0, atol=1e-5)


def test_text_classifier_refuses_what_the_reference_refuses(tiny_tower, bpe_file):
    _cfg, _enc, params = tiny_tower
    cfg = port_tiny_cfg()
    tower = build_text_tower(cfg, "cpu", params=params["params"])
    bg, ls = np.zeros((1, cfg.san.clip_embed_dim), np.float32), np.float32(1.0)
    with pytest.raises(ValueError, match="no BPE vocab"):
        text_classifier(cfg, ["car"], tower, bg, ls)
    s = cfg.san
    other = CLIPTextEncoder(s.text_width, s.text_heads, s.text_layers, s.clip_embed_dim,
                            vocab_size=1000)
    with pytest.raises(ValueError, match="vocab size 1000"):
        text_classifier(cfg, ["car"], other, bg, ls, bpe_path=bpe_file)


def test_text_tower_loader_is_strict(tiny_tower):
    _cfg, _enc, params = tiny_tower
    cfg = port_tiny_cfg()
    s = cfg.san
    make = lambda: CLIPTextEncoder(s.text_width, s.text_heads, s.text_layers,  # noqa: E731
                                   s.clip_embed_dim)
    tree = np_tree(params["params"])
    load_text_tower(make(), tree)
    missing = {k: v for k, v in tree.items() if k != "ln_final"}
    with pytest.raises(ValueError, match="no JAX leaf"):
        load_text_tower(make(), missing)
    leftover = dict(tree, logit_scale=np.float32(1.0))
    with pytest.raises(ValueError, match="not consumed"):
        load_text_tower(make(), leftover)
    short = dict(tree, resblocks={"block": {k: v for k, v in tree["resblocks"]["block"].items()
                                            if k != "mlp"}})
    with pytest.raises(ValueError, match="no JAX leaf"):
        load_text_tower(make(), short)


def test_seeded_text_tower_is_fp32_and_reproducible():
    """One seed, one tower; fp32 weights and outputs even for a bf16 model."""
    import dataclasses

    cfg = dataclasses.replace(presets.veon_tiny_test(), compute_dtype="bfloat16")
    a = build_text_tower(cfg, "cpu", seed=3)
    b = build_text_tower(cfg, "cpu", seed=3)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert x.dtype == torch.float32 and torch.equal(x, y), k
    assert a.token_embedding.weight.std() > 0
    out = a(torch.from_numpy(ptext.ClipTokenizer().tokenize(["a car"])))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_text_tower_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_text_tower(presets.veon_tiny_test())
