"""DALL-E decoder-only transformer over [text ; image] tokens: the serving
half of ``dalle_mtf_tpu/models/dalle.py``, in PyTorch.

Parameters are a plain nested dict of tensors with the JAX tree's names and
shapes (stacked on a leading [n_layers] axis: ``layers.wq [L,E,H,D]``,
``layers.wo [L,H,D,E]``, ``w_out [E,V]``), so weights cross between the two
packages as a plain mapping (utils/convert.py). Transposes and reshapes
happen only inside the ops.

Unlike the JAX package, whose KV cache is a functional pytree updated with
dynamic_update_slice, ``prefill``/``decode_step`` write the cache IN PLACE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_mtf_tpu_torch.ops.attention import causal_attention, decode_attention
from dalle_mtf_tpu_torch.utils.precision import Policy, get_policy

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "swish": F.silu,
}


@dataclasses.dataclass(frozen=True)
class DalleConfig:
    """The fields serving reads (``dalle_mtf_tpu.models.dalle.DalleConfig``);
    the JAX config's training and layout fields are accepted by
    ``from_params`` and ignored."""

    n_embd: int
    text_vocab_size: int = 12800
    image_vocab_size: int = 512
    text_seq_len: int = 256
    image_seq_len: int = 1024
    n_layers: int = 6
    n_heads: int = 8
    bf_16: bool = False
    attention_type: str = "global"
    local_attention_radius: int = 256
    scale_type: str = "scale_by_depth"
    activation: str = "relu"
    ln_dtype: str = "float32"  # | "activation"

    @classmethod
    def from_params(
        cls, params: Mapping[str, Any], image_seq_len: int
    ) -> "DalleConfig":
        if (params.get("ln_impl") or "xla") != "xla":
            raise NotImplementedError(
                "ln_impl='pallas' (the fused LN kernel) is not ported yet"
            )
        return cls(
            n_embd=params["n_embd"],
            text_vocab_size=params["text_vocab_size"],
            image_vocab_size=params["image_vocab_size"],
            text_seq_len=params["text_seq_len"],
            image_seq_len=image_seq_len,
            n_layers=params["n_layers"],
            n_heads=params["n_heads"],
            bf_16=bool(params.get("bf_16")),
            attention_type=params.get("attention_type") or "global",
            local_attention_radius=params.get("local_attention_radius") or 256,
            scale_type=params.get("scale_type") or "scale_by_depth",
            activation=params.get("activation") or "relu",
            ln_dtype=params.get("ln_dtype") or "float32",
        )

    @property
    def total_tokens(self) -> int:
        # text + image vocab + 1 EOS (reference models.py:157-158)
        return self.text_vocab_size + self.image_vocab_size + 1

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_heads == 0, "n_embd must divide n_heads"
        return self.n_embd // self.n_heads

    @property
    def policy(self) -> Policy:
        return get_policy(self.bf_16)


class DALLE(nn.Module):
    """The model's computation over an explicit parameter tree.

    The module holds the config and the device; the parameters are the
    nested dict ``init`` returns (or ``utils.convert`` loads), passed to
    every method, as in the JAX package.
    """

    def __init__(self, config: DalleConfig, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = config
        self.device = torch.device(device)

    # ------------------------------------------------------------------ init

    def param_shapes(self) -> dict:
        """The parameter tree's shapes, keyed like the JAX tree."""
        cfg = self.cfg
        e, h, d, L = cfg.n_embd, cfg.n_heads, cfg.head_dim, cfg.n_layers
        inter = 4 * e
        return {
            "wte": (cfg.total_tokens, e),
            "wpe": (cfg.total_seq_len, e),
            "layers": {
                "ln1_g": (L, e), "ln1_b": (L, e),
                "wq": (L, e, h, d), "wk": (L, e, h, d), "wv": (L, e, h, d),
                "wo": (L, h, d, e), "o_b": (L, e),
                "ln2_g": (L, e), "ln2_b": (L, e),
                "w_mlp1": (L, e, inter), "b_mlp1": (L, inter),
                "w_mlp2": (L, inter, e), "b_mlp2": (L, e),
            },
            "lnf_g": (e,), "lnf_b": (e,),
            "w_out": (e, cfg.total_tokens), "b_out": (cfg.total_tokens,),
        }

    def init(self, generator: torch.Generator) -> dict:
        """Random fp32 parameters with the JAX init's shapes and stddevs
        (dalle.py:358-407; the reference's linear() scaling, models.py:
        361-371). Drawn on ``generator``'s device (a CPU generator gives the
        same weights on every device), then moved to ``self.device``."""
        cfg = self.cfg
        e = cfg.n_embd
        mlp1_std = logits_std = 0.02
        if cfg.scale_type == "scale_by_depth":
            mlp2_std = 0.02 / math.sqrt(cfg.n_layers)
        elif cfg.scale_type == "scale_by_in":
            mlp1_std = 0.02 / math.sqrt(e)
            mlp2_std = 0.02 / math.sqrt(4 * e)
            logits_std = 0.02 / math.sqrt(e)
        else:
            mlp2_std = 0.02
        std = {
            "wq": 0.02, "wk": 0.02, "wv": 0.02, "wo": 0.02,
            "w_mlp1": mlp1_std, "w_mlp2": mlp2_std,
            "wte": 0.02, "wpe": 0.01, "w_out": logits_std,
        }
        gdev = generator.device

        def make(name, shape):
            if name in std:
                t = torch.randn(shape, generator=generator, device=gdev) * std[name]
            elif name.endswith("_g"):
                t = torch.ones(shape)
            else:
                t = torch.zeros(shape)
            return t.to(device=self.device, dtype=torch.float32)

        shapes = self.param_shapes()
        return {
            k: ({n: make(n, s) for n, s in v.items()} if isinstance(v, dict)
                else make(k, v))
            for k, v in shapes.items()
        }

    # --------------------------------------------------------------- helpers

    @property
    def _window(self):
        return (
            self.cfg.local_attention_radius
            if self.cfg.attention_type in ("local", "local_ring")
            else None
        )

    def _layer_norm(self, x, g, b, eps=1e-5):
        # reference layer_norm (models.py:373-389): normalize then affine.
        # ln_dtype "activation" runs the chain in x.dtype like the
        # reference's norm; "float32" upcasts around the normalize.
        ct = torch.float32 if self.cfg.ln_dtype == "float32" else x.dtype
        xc = x.to(ct)
        mean = xc.mean(dim=-1, keepdim=True)
        var = xc.var(dim=-1, keepdim=True, unbiased=False)
        out = (xc - mean) * torch.rsqrt(var + eps)
        out = out * g.to(ct) + b.to(ct)
        return out.to(x.dtype)

    def _w(self, p, name):
        return p[name].to(self.cfg.policy.compute_dtype)

    def _qkv(self, p, a_in):
        """[B, S, E] -> contiguous q, k, v [B, H, S, D]."""
        b, s, e = a_in.shape
        h, d = self.cfg.n_heads, self.cfg.head_dim

        def proj(name):
            y = a_in @ self._w(p, name).reshape(e, h * d)
            return y.reshape(b, s, h, d).transpose(1, 2).contiguous()

        return proj("wq"), proj("wk"), proj("wv")

    def _attn_out(self, p, a):
        """[B, H, S, D] -> [B, S, E] (the bhsd,hde->bse einsum) + o_b."""
        b, h, s, d = a.shape
        w = self._w(p, "wo").reshape(h * d, -1)
        y = a.transpose(1, 2).reshape(b, s, h * d) @ w
        return y + p["o_b"].to(y.dtype)

    def _mlp(self, p, m_in):
        dtype = self.cfg.policy.compute_dtype
        act = _ACTIVATIONS[self.cfg.activation]
        hdn = act(m_in @ self._w(p, "w_mlp1") + p["b_mlp1"].to(dtype))
        return hdn @ self._w(p, "w_mlp2") + p["b_mlp2"].to(dtype)

    def logits_head(self, params, band: tuple[int, int] | None = None):
        """(w [E, n] fp32, b [n] fp32) for ``_last_logits``: w_out's columns
        [lo, hi) (all when ``band`` is None), rounded through the compute
        dtype as the JAX head reads them. Built once per generation, not
        per token."""
        lo, hi = band if band is not None else (0, self.cfg.total_tokens)
        w = params["w_out"][:, lo:hi].to(self.cfg.policy.compute_dtype)
        return w.float().contiguous(), params["b_out"][lo:hi].float()

    def _last_logits(self, head, x_last):
        """[B, E] final-LN'd hidden -> fp32 logits [B, n] over the head's
        columns. The product takes compute-dtype operands and accumulates
        in fp32 (the JAX head's preferred_element_type): bf16 operands are
        exact in fp32, so an fp32 matmul of them is that product. With a
        band only the image-token columns exist; every other column would be
        masked out by sampling anyway, so the banded head is exact."""
        w, b = head
        x = x_last.to(self.cfg.policy.compute_dtype).float()
        return x @ w + b

    def _layers(self, params) -> list[dict]:
        """Per-layer views of the stacked [L, ...] parameters."""
        return [
            {n: t[i] for n, t in params["layers"].items()}
            for i in range(self.cfg.n_layers)
        ]

    # --------------------------------------------------------- KV-cache path

    def init_cache(self, batch: int, max_len: int | None = None) -> dict:
        cfg = self.cfg
        s = max_len or cfg.total_seq_len
        shape = (cfg.n_layers, batch, cfg.n_heads, s, cfg.head_dim)
        dtype = cfg.policy.compute_dtype
        return {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
        }

    def prefill(self, params, tokens, cache: dict, band=None, head=None):
        """Run the prompt through the model, writing cache[:, :, :, :S] in
        place. Returns fp32 logits at the last position, [B, vocab] or
        [B, hi-lo] with ``band=(lo, hi)`` (``head`` from ``logits_head``
        takes the band's place when the caller already built it)."""
        return self.prefill_rows(params, tokens, cache, None, band, head)

    def prefill_rows(self, params, tokens, cache: dict, row_mask,
                     band=None, head=None):
        """``prefill`` that writes the cache only on ``row_mask`` rows
        (bool [B]; None = every row). Returns the last-position logits of
        every row; only the masked rows' are meaningful."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        t = tokens.shape[1]
        # embeddings rounded to the compute dtype BEFORE the add
        # (dalle.py:1249), so bf16 rounds where JAX rounds (gathering
        # first and casting the rows is the same elementwise cast)
        x = params["wte"][tokens].to(dtype) + params["wpe"][:t].to(dtype)
        for layer, p in enumerate(self._layers(params)):
            a_in = self._layer_norm(x, p["ln1_g"], p["ln1_b"])
            q, k, v = self._qkv(p, a_in)
            a = causal_attention(q, k, v, window=self._window)
            x = x + self._attn_out(p, a)
            m_in = self._layer_norm(x, p["ln2_g"], p["ln2_b"])
            x = x + self._mlp(p, m_in)
            for name, new in (("k", k), ("v", v)):
                dst = cache[name][layer, :, :, :t]
                if row_mask is None:
                    dst.copy_(new)
                else:
                    dst.copy_(torch.where(row_mask[:, None, None, None], new, dst))
        x = self._layer_norm(x[:, -1], params["lnf_g"], params["lnf_b"])
        return self._last_logits(head or self.logits_head(params, band), x)

    def decode_step(self, params, cache: dict, token, position: int,
                    band=None, head=None):
        """One incremental step: token [B] at ``position`` -> fp32 logits
        [B, vocab] ([B, hi-lo] with ``band``). Each layer writes its k/v at
        ``position`` into the cache in place (the JAX step returns a new
        cache instead)."""
        head = head or self.logits_head(params, band)
        position = int(position)
        dtype = self.cfg.policy.compute_dtype
        x = params["wte"][token].to(dtype) + params["wpe"][position].to(dtype)
        x = x[:, None, :]  # [B, 1, E]
        for layer, p in enumerate(self._layers(params)):
            a_in = self._layer_norm(x, p["ln1_g"], p["ln1_b"])
            q, k_new, v_new = self._qkv(p, a_in)
            k_all, v_all = cache["k"][layer], cache["v"][layer]
            k_all[:, :, position] = k_new[:, :, 0]
            v_all[:, :, position] = v_new[:, :, 0]
            a = decode_attention(q, k_all, v_all, position, window=self._window)
            x = x + self._attn_out(p, a)
            m_in = self._layer_norm(x, p["ln2_g"], p["ln2_b"])
            x = x + self._mlp(p, m_in)
        x = self._layer_norm(x[:, 0], params["lnf_g"], params["lnf_b"])
        return self._last_logits(head, x)
