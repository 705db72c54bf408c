"""The port's CLIP tokenizer (mpreid_tpu_torch/models/tokenizer.py) against
the JAX package's (mpreid_tpu/models/tokenizer.py).

The port needs neither ``regex`` nor ``ftfy``: its ids must equal the JAX
``tokenize``'s on the prompt template, on ASCII text and on the non-ASCII
strings of ``tests/test_tokenizer.py``, with the JAX module taking its own
ftfy-less branch (the one the port copies), numbers that are not decimal
digits included.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mpreid_tpu.models import tokenizer as jtok
from mpreid_tpu_torch.models import tokenizer as ttok
from mpreid_tpu_torch.models.uniprompt import prompt_template_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    # the prompt template and ASCII
    " ".join(["X"] * 16) + " person.",
    "a photo of a person.",
    "  spaced\t\tout\n text  ",
    "punct!!! ... 'contractions' don't fail",
    "Numbers 12345 and MIXED case Text",
    "snake_case __init__ a_b!_ <|endoftext|>",
    # tests/test_tokenizer.py's non-ASCII and HTML strings
    "fish &amp; chips", "&amp;amp; double-escaped", "&lt;tag&gt;",
    "café person", "café person", "naïve résumé", "cafÃ©", "naÃ¯ve",
    "don’t stop", "ﬁsh ﬁlet", "e&#769;",
    # letters, decimal digits and marks of other scripts
    "Ελληνικά ру́сский 中文字 日本語 한국어 ٣٤٥ १२३ emoji 😀👍",
]


@pytest.fixture
def jax_fallback(monkeypatch):
    """The JAX tokenizer on its ftfy-less branch, whatever is installed."""
    monkeypatch.setattr(jtok, "_ftfy", None)
    return jtok.get_tokenizer()


@pytest.mark.parametrize("text", TEXTS)
def test_ids_equal_jax(jax_fallback, text):
    assert ttok.get_tokenizer().encode(text) == jax_fallback.encode(text)


def test_tokenize_and_template_equal_jax(jax_fallback):
    texts = TEXTS[:6]
    got = ttok.tokenize(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, jtok.tokenize(texts))
    template = prompt_template_tokens()
    np.testing.assert_array_equal(template, jtok.tokenize(" ".join(["X"] * 16) + " person."))
    assert list(ttok.tokenize("a photo of a person.")[0, :8]) == [
        49406, 320, 1125, 539, 320, 2533, 269, 49407]
    long = " ".join(["word"] * 100)
    with pytest.raises(RuntimeError, match="too long"):
        ttok.tokenize(long)
    np.testing.assert_array_equal(ttok.tokenize(long, truncate=True),
                                  jtok.tokenize(long, truncate=True))


@pytest.mark.parametrize("text,spaced", [("x²", False), ("½½", False), ("x ² ½ Ⅻ", True)])
def test_non_decimal_numbers_are_the_documented_difference(jax_fallback, text, spaced):
    """``\\p{N}`` splits a non-decimal number (No, Nl) off one character at a
    time, and so does the port, where the stdlib's ``\\w`` alone would keep it
    in a word with what touches it: touching or apart, the ids equal JAX's,
    and a touching number tokenizes as if it stood apart."""
    tok = ttok.get_tokenizer()
    assert tok.encode(text) == jax_fallback.encode(text)
    if not spaced:
        assert tok.encode(text) == tok.encode(" ".join(text))


def test_decode_round_trip():
    tok = ttok.get_tokenizer()
    assert tok.decode(tok.encode("hello world!!")).strip() == "hello world !!"


def test_merge_table_is_the_jax_packages_byte_for_byte():
    digests = []
    for pkg in ("mpreid_tpu", "mpreid_tpu_torch"):
        with open(os.path.join(REPO, pkg, "models", "assets", "bpe_simple_vocab_16e6.txt.gz"),
                  "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]


def test_tokenizes_without_regex_or_ftfy():
    """With ``regex`` and ``ftfy`` unimportable, the port's tokenizer loads
    and gives the same ids."""
    code = (
        "import json, sys\n"
        "sys.modules['regex'] = None\nsys.modules['ftfy'] = None\n"
        "from mpreid_tpu_torch.models import tokenizer, uniprompt\n"
        f"ids = [tokenizer.get_tokenizer().encode(t) for t in {TEXTS!r}]\n"
        "print(json.dumps([ids, uniprompt.prompt_template_tokens().tolist(),"
        " sorted(m for m, v in sys.modules.items()"
        " if v is not None and m.split('.')[0] in ('regex', 'ftfy', 'jax'))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120)
    ids, template, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == []
    assert ids == [ttok.get_tokenizer().encode(t) for t in TEXTS]
    assert template == prompt_template_tokens().tolist()
