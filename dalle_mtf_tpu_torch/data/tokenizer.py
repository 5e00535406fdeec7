"""Caption tokenizer.

Reference (src/data/tokenizer_utils.py:4-16): HuggingFace GPT-2 tokenizer
with an added ``<|padding|>`` special token, total vocab 50258; the padding
id is recorded into params at train time (train_dalle.py:47-49).

In fully-offline environments (no HF cache, no network) we fall back to a
deterministic byte-level tokenizer occupying the same id space (ids 0-255 +
pad at 50257), so smoke tests and dataset tooling work anywhere. The fallback
is API-compatible; swap in the real GPT-2 vocab for production training.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

GPT2_VOCAB = 50257
PAD_TOKEN = "<|padding|>"


class ByteTokenizer:
    """Offline fallback: UTF-8 bytes as tokens, GPT-2-sized id space."""

    is_fallback = True

    def __init__(self):
        self.pad_token = PAD_TOKEN
        self.pad_token_id = GPT2_VOCAB  # 50257, same slot the HF path uses

    def __len__(self):
        return GPT2_VOCAB + 1  # 50258

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


def get_tokenizer(name: str = "gpt2"):
    """GPT-2 (fast) tokenizer + <|padding|> — vocab 50258. Falls back to
    ByteTokenizer when HF weights are unreachable."""
    try:
        from transformers import GPT2TokenizerFast  # noqa: PLC0415

        # local_files_only: a cache/network miss must fail fast, not retry
        # HTTP forever — air-gapped TPU pods are a supported deployment.
        # Set DALLE_TPU_TOKENIZER_DOWNLOAD=1 to allow fetching.
        import os  # noqa: PLC0415

        local_only = os.environ.get("DALLE_TPU_TOKENIZER_DOWNLOAD") != "1"
        tok = GPT2TokenizerFast.from_pretrained(name, local_files_only=local_only)
        tok.add_special_tokens({"pad_token": PAD_TOKEN})
        tok.is_fallback = False
        return tok
    except Exception as e:
        logger.warning(
            "GPT-2 tokenizer unavailable (%s) — using byte-level fallback "
            "with the same 50258-id space", type(e).__name__,
        )
        return ByteTokenizer()


def pad_or_truncate(ids: list[int], length: int, pad_id: int) -> list[int]:
    """Pad-then-truncate to ``length`` (reference input_fns.py:32-38)."""
    return (list(ids) + [pad_id] * length)[:length]
