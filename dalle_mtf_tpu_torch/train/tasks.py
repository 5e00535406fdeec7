"""Task definitions binding the DALLE model to the Trainer (port of
``dalle_mtf_tpu/train/tasks.py``): model construction from a config, and
the train and eval losses over (params, frozen_params, batch, generator,
step).

Only the tokens mode is ported: batches carry pre-tokenized image ids
(``{"tokens", "caption"}``). The image mode, which runs the frozen VAE
encoder on pixels inside the loss, waits for the VAE encoder and raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig
from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig
from dalle_mtf_tpu_torch.ops.losses import softmax_cross_entropy_with_logits


def _configs(params: Mapping[str, Any]) -> tuple[DalleConfig, VAEConfig]:
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
    return cfg, vae_cfg


def make_dalle_models(params: Mapping[str, Any], device: torch.device | str):
    """DALLE config (with ``vae_params`` nested, as fetch_model_params
    loads it) -> (dalle, vae) on ``device``."""
    cfg, vae_cfg = _configs(params)
    return DALLE(cfg, device), DiscreteVAE(vae_cfg, device)


def make_dalle_task(params: Mapping[str, Any], device: torch.device | str, mesh=None):
    """Returns (dalle, init_fn, train_loss_fn, eval_loss_fn).

    ``init_fn(generator)`` draws the fp32 parameter tree. The loss functions
    take (params, frozen_params, batch, generator, step) with a batch of
    torch tensors on the device and return (scalar loss, aux dict). On a
    ``mesh`` the batch holds this rank's rows, and every value returned is
    this rank's share of the global mean (the trainer sums them over the
    ranks)."""
    cfg, _ = _configs(params)
    dalle = DALLE(cfg, device, mesh)
    z_loss = params.get("z_loss") or 0.0
    text_len = cfg.text_seq_len

    def tokens_of(_frozen, batch):
        if "tokens" not in batch:
            raise NotImplementedError(
                "image-mode batches need the frozen VAE encoder, which is not "
                "ported yet; use a tokens dataset (dataset.tokens: true)"
            )
        # record ids are raw codebook ids; the text-vocab offset applies here
        img_tokens = batch["tokens"].long() + cfg.text_vocab_size
        return torch.cat([batch["caption"].long(), img_tokens], dim=1)

    def _split_losses(loss_batch):
        # loss_batch[:, i] scores the prediction of token i+1, so image
        # modeling starts at position text_seq_len - 1
        return {
            "loss_text": dalle.global_mean(loss_batch, 0, text_len - 1),
            "loss_image": dalle.global_mean(loss_batch, text_len - 1),
        }

    def train_loss(p, frozen, batch, generator, step):
        tokens = tokens_of(frozen, batch)
        loss, loss_batch = dalle.loss(p, tokens, generator, train=True, z_loss=z_loss)
        return loss, _split_losses(loss_batch)

    def eval_loss(p, frozen, batch, generator, step):
        """Loss split plus next-token accuracy (overall and image
        positions), on the fp32 logits of ``forward``."""
        tokens = tokens_of(frozen, batch)
        logits = dalle.forward(p, tokens, generator, train=False)
        labels = dalle.local_labels(tokens)
        loss_batch = softmax_cross_entropy_with_logits(logits, labels, z_loss)
        correct = (logits.argmax(dim=-1) == labels).float()
        return dalle.global_mean(loss_batch), {
            **_split_losses(loss_batch),
            "acc": dalle.global_mean(correct),
            "acc_image": dalle.global_mean(correct, text_len - 1),
        }

    return dalle, dalle.init, train_loss, eval_loss
