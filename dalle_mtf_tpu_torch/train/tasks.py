"""Model construction from a config (the model-building half of
``dalle_mtf_tpu/train/tasks.py::make_dalle_task``). The training losses
arrive with the training port."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig
from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig


def make_dalle_models(params: Mapping[str, Any], device: torch.device | str):
    """DALLE config (with ``vae_params`` nested, as fetch_model_params
    loads it) -> (dalle, vae) on ``device``."""
    vae_cfg = VAEConfig.from_params(params["vae_params"])
    cfg = DalleConfig.from_params(params, vae_cfg.image_seq_len)
    # Hard guard: VAE token ids are offset into [text_vocab, text_vocab +
    # image_vocab); a mismatch silently clamps image tokens onto the EOS
    # embedding row. (The reference ships exactly this latent bug: its
    # dalle_coco.json says image_vocab_size 512 against vae_coco's
    # num_tokens 2048.)
    if cfg.image_vocab_size != vae_cfg.num_tokens:
        raise ValueError(
            f"image_vocab_size ({cfg.image_vocab_size}) must equal the VAE's "
            f"num_tokens ({vae_cfg.num_tokens}) — fix the dalle config"
        )
    return DALLE(cfg, device), DiscreteVAE(vae_cfg, device)
