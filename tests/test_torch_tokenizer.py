"""The port's tokenizer and chat templates (``pygpukit_tpu_torch.llm.
tokenizer``, ``.chat``) against the JAX package's and the HF ``tokenizers``
runtime, on a byte-level BPE ``tokenizer.json`` trained here (no download).

- The port's own byte-level BPE (what runs where ``tokenizers`` is
  missing) gives the reference's own BPE ids on a fixed corpus (ASCII,
  multi-byte UTF-8, the chat specials, double spaces) and the HF runtime's
  ids and text on every text here.
- The port's ``Tokenizer`` gives the reference ``Tokenizer``'s ids (both
  through the HF runtime here).
- Known faults of the reference's own BPE, recorded and not expected of
  the port: it splits words on spaces only, where GPT-2's pattern keeps a
  run of spaces together (three spaces or more differ from HF), and it
  decodes token by token, so a character split over two tokens becomes
  replacement characters.
- Chat and guard templates give the reference's strings exactly.
"""

import json

import pytest

from pygpukit_tpu.llm import chat as ref_chat
from pygpukit_tpu.llm import tokenizer as ref_tok
import pygpukit_tpu_torch.llm as pl
from pygpukit_tpu_torch.llm import chat as port_chat
from pygpukit_tpu_torch.llm import tokenizer as port_tok

tokenizers = pytest.importorskip("tokenizers")

SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
TRAIN = [
    "The quick brown fox jumps over the lazy dog. It's 2024, isn't it?",
    "Hello, world! Hello again, world; hello hello HELLO.",
    "café naïve résumé über straße — 日本語のテキスト 中文 한국어 😀👍",
    "def main():\n    print('hi')\n    return 0\n\n",
    "numbers 12345 67890 3.14159 and tabs\tand\ttabs",
    "We'll see, they've said, you're right, I'm here, he'd go.",
] * 4
# the fixed corpus on which the port's own BPE must give the reference's
CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello, world!  Two  spaces  between.",
    "café naïve über straße 日本語 😀",
    "<|im_start|>user\nWhat's 2+2?<|im_end|>\n<|im_start|>assistant\n",
    "It's 2024; isn't it? 3.14",
    "",
    " leading space",
    "unknown bytes \x00\x7f and ÿ",
]
# texts where GPT-2's pattern splits otherwise than the reference's spaces
KNOWN_FAULT = ["a   b", "three   spaces and trailing   ", "x    \n  y"]
EXTRA = ["tabs\tand\nnewlines\n\n", "  two leading", "emoji 👍👍 run", "'s 'll 're",
         "ABC123def", "line one\r\nline two", "¡señor! ¿qué?", "a b"]


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=SPECIALS,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(TRAIN, trainer=trainer)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return path


@pytest.fixture(scope="module")
def hf(tokenizer_json):
    return tokenizers.Tokenizer.from_file(str(tokenizer_json))


@pytest.mark.parametrize("text", CORPUS)
def test_own_bpe_gives_the_references_ids(tokenizer_json, text):
    port = port_tok._ByteLevelBPE(str(tokenizer_json))
    ref = ref_tok._ByteLevelBPE(str(tokenizer_json))
    assert port.encode(text) == ref.encode(text)


@pytest.mark.parametrize("text", CORPUS + KNOWN_FAULT + EXTRA)
def test_own_bpe_gives_the_hf_runtimes_ids_and_text(tokenizer_json, hf, text):
    port = port_tok._ByteLevelBPE(str(tokenizer_json))
    ids = port.encode(text)
    assert ids == hf.encode(text).ids
    assert port.decode(ids) == hf.decode(ids, skip_special_tokens=False)


@pytest.mark.parametrize("text", KNOWN_FAULT)
def test_known_fault_the_references_own_bpe_splits_space_runs(tokenizer_json, hf, text):
    """Recorded fault of the reference (``_split_words`` splits at each
    space): its ids differ from HF's on a run of three spaces or more,
    where the port's equal HF's."""
    ref = ref_tok._ByteLevelBPE(str(tokenizer_json))
    port = port_tok._ByteLevelBPE(str(tokenizer_json))
    assert ref.encode(text) != hf.encode(text).ids
    assert port.encode(text) == hf.encode(text).ids


def test_known_fault_the_references_own_bpe_decodes_token_by_token(tokenizer_json, hf):
    """Recorded fault of the reference: a character whose bytes lie in two
    tokens decodes as replacement characters; the port decodes a run of
    tokens as one byte string, as HF does."""
    port = port_tok._ByteLevelBPE(str(tokenizer_json))
    ref = ref_tok._ByteLevelBPE(str(tokenizer_json))
    text = "한국어"             # rare in training: its bytes stay split over tokens
    ids = hf.encode(text).ids
    assert len(ids) > len(text)
    assert port.decode(ids) == hf.decode(ids) == text
    assert ref.decode(ids) != text


@pytest.mark.parametrize("text", CORPUS + EXTRA)
def test_port_tokenizer_gives_the_reference_tokenizers_ids(tokenizer_json, text):
    port = pl.Tokenizer(str(tokenizer_json.parent))
    ref = ref_tok.Tokenizer(str(tokenizer_json.parent))
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == ref.decode(ids)


def test_own_bpe_tokenizer_without_the_hf_runtime(tokenizer_json, hf, monkeypatch):
    """Where ``tokenizers`` does not import (the card's machine) the
    Tokenizer serves through the own BPE, with HF's answers."""
    import builtins
    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kw):
        if name == "tokenizers":
            raise ImportError("no tokenizers")
        return real_import(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    port = pl.Tokenizer(str(tokenizer_json))
    assert port._hf is None and port._bpe is not None
    for text in CORPUS + EXTRA:
        assert port.encode(text) == hf.encode(text).ids
    assert port.vocab_size == hf.get_vocab_size()
    for tok in ["<|im_end|>", "Ġthe", "zzzz-not-a-token"]:
        assert port.token_to_id(tok) == hf.token_to_id(tok)


def test_vocab_size_and_token_to_id_through_hf(tokenizer_json, hf):
    port, ref = pl.Tokenizer(str(tokenizer_json)), ref_tok.Tokenizer(str(tokenizer_json))
    assert port.vocab_size == ref.vocab_size == hf.get_vocab_size()
    for tok in SPECIALS + ["Ġquick", "nope"]:
        assert port.token_to_id(tok) == ref.token_to_id(tok)


def test_bytes_to_unicode_is_the_references():
    assert port_tok._bytes_to_unicode() == ref_tok._bytes_to_unicode()


@pytest.mark.parametrize("text", CORPUS + EXTRA + KNOWN_FAULT)
def test_split_words_is_gpt2s_pattern(text):
    regex = pytest.importorskip("regex")
    pat = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    assert port_tok._split_words(text) == pat.findall(text)


# ---------------------------------------------------------------------------
# Chat templates
# ---------------------------------------------------------------------------

CONVERSATIONS = [
    [{"role": "user", "content": "Hi"}],
    [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "2+2?"},
     {"role": "assistant", "content": "4"}, {"role": "user", "content": "And 3+3?"}],
    [{"role": "system", "content": ""}, {"role": "user", "content": "multi\nline ü"}],
]


@pytest.mark.parametrize("template", ["chatml", "llama2", "llama3", "plain", "other"])
@pytest.mark.parametrize("gen", [True, False])
@pytest.mark.parametrize("conv", range(len(CONVERSATIONS)))
def test_chat_templates_give_the_references_strings(template, gen, conv):
    msgs = CONVERSATIONS[conv]
    as_objects = [port_chat.ChatMessage(**m) for m in msgs]
    want = ref_chat.apply_chat_template(msgs, template, gen)
    assert port_chat.apply_chat_template(msgs, template, gen) == want
    assert port_chat.apply_chat_template(as_objects, template, gen) == want
    assert port_chat.format_chat_messages(msgs, template) == \
        ref_chat.format_chat_messages(msgs, template)


@pytest.mark.parametrize("conv", range(len(CONVERSATIONS)))
@pytest.mark.parametrize("cats", [None, ["S1: One", "S2: Two"]])
def test_guard_template_gives_the_references_string(conv, cats):
    msgs = CONVERSATIONS[conv]
    assert port_chat.apply_guard_template(msgs, cats) == \
        ref_chat.apply_guard_template(msgs, cats)


@pytest.mark.parametrize("system", [None, "You are terse."])
@pytest.mark.parametrize("template", ["chatml", "llama3"])
def test_create_chat_prompt_gives_the_references_string(system, template):
    assert port_chat.create_chat_prompt(system, "Hello?", template) == \
        ref_chat.create_chat_prompt(system, "Hello?", template)
    assert port_chat.TEMPLATES == ref_chat.TEMPLATES


def test_chatml_prompt_round_trips_through_the_tokenizer(tokenizer_json):
    tok = pl.Tokenizer(str(tokenizer_json))
    prompt = pl.apply_chat_template(CONVERSATIONS[1])
    ids = tok.encode(prompt)
    assert tok.token_to_id("<|im_start|>") in ids
    assert tok.decode(ids) == prompt
    assert json.loads(tokenizer_json.read_text())["added_tokens"][1]["content"] == "<|im_start|>"
