"""Task definitions binding the models to the Trainer (port of
``dalle_mtf_tpu/train/tasks.py``): model construction from a config, and
the train and eval losses over (params, frozen_params, batch, generator,
step).

- ``make_vae_task``: stage 1, on image batches ``{"image"}`` (f32 in
  [-1, 1], or uint8 normalized on the device), with the annealed Gumbel
  temperature and the eval's PSNR, codebook perplexity and Fréchet feature
  distance.
- ``make_dalle_task``: stage 2, on image batches ``{"image", "caption"}``
  (image mode: the frozen VAE, restored by ``utils/restore.py`` and passed
  as the trainer's ``frozen_params``, tokenizes the pixels on the device
  inside the loss) or on pre-tokenized batches ``{"tokens", "caption"}``
  (tokens mode: records written by ``data/encode_dataset.py``). Both modes
  build the same [caption ; image ids + text vocab] sequence. With
  ``fused_xent`` the loss and the eval stream the head over row chunks
  (``DALLE.loss(fused_xent=True)``, ``DALLE.fused_eval``) with the same
  metrics.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig
from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig, temperature_schedule
from dalle_mtf_tpu_torch.ops.losses import frechet_feature_distance
from dalle_mtf_tpu_torch.parallel.tensor import all_reduce


def _image(batch) -> torch.Tensor:
    """Batch images in the compute range [-1, 1]: f32 batches pass through
    (normalized on the host); uint8 batches (``dataset.uint8_images``, a 4x
    smaller host-to-device copy) are normalized here, on the device, with
    the host's (x - 127.5) / 127.5 in f32, so the values are the same. The
    divisor is a tensor on the image's device: CUDA divides by a host scalar
    as a multiply by its reciprocal, which is one ulp off the division for
    126 of the 256 pixel values."""
    x = batch["image"]
    if x.dtype == torch.uint8:
        return (x.float() - 127.5) / torch.full((), 127.5, device=x.device)
    return x


def make_vae_task(params: Mapping[str, Any], device: torch.device | str, mesh=None):
    """Returns (vae, init_fn, train_loss_fn, eval_loss_fn) for stage 1
    (model_fns_tf.py:9-66): the Gumbel temperature annealed by the step,
    the sample soft or hard in training and in eval as the config says
    (``train_gumbel_hard``, ``eval_gumbel_hard``; default hard).

    On a ``mesh`` the batch holds this rank's rows, and every value returned
    is this rank's share of the global value, so that the trainer's sum over
    the mesh's replicas (``Mesh.replica_group``, the batch axis) is the
    single process's: the losses are the local means over the replicas; the
    eval metrics, which are not means, are computed once from statistics
    all_reduced over the replicas (PSNR from the global squared error, the
    perplexity from the global token counts, the Fréchet feature distance
    from the global feature means and variances) and divided by the
    replicas. A rule on ``tokens_dim`` or ``vae_hid_dim`` splits the
    codebook and one on the conv dims the convs over the tensor-parallel
    axis (models/vae.py); the model group then computes these statistics
    from whole tensors (the reconstruction, the tokens and the pooled
    features come out whole on each of its ranks)."""
    cfg = VAEConfig.from_params(params)
    vae = DiscreteVAE(cfg, device, mesh)
    replicas = vae.mesh.replicas if vae.mesh is not None else 1
    group = vae.mesh.replica_group if vae.mesh is not None else None

    def global_sum(t):
        return all_reduce(t, group) if replicas > 1 else t

    train_hard = params.get("train_gumbel_hard")
    train_hard = True if train_hard is None else bool(train_hard)
    eval_hard = params.get("eval_gumbel_hard")
    eval_hard = True if eval_hard is None else bool(eval_hard)

    def train_loss(p, _frozen, batch, generator, step):
        loss, _recon = vae.forward(p, _image(batch), generator,
                                   temperature_schedule(params, step), train_hard, train=True)
        return loss / replicas, {}

    def eval_loss(p, _frozen, batch, generator, step):
        """The loss and the JAX package's quality metrics: PSNR of the
        reconstruction (on the [-1, 1] scale, peak 2), the codebook
        perplexity (exp of the entropy of the hard tokens' usage; collapse
        shows as perplexity << num_tokens) and the Fréchet feature distance
        between real and reconstructed images in the encoder's pooled
        feature space."""
        img = _image(batch)
        loss, recon = vae.forward(p, img, generator, temperature_schedule(params, step),
                                  eval_hard, train=False)
        err = torch.square(img.float() - recon)
        mse = global_sum(err.sum().reshape(1))[0] / (err.numel() * replicas)
        psnr = 10.0 * torch.log10(4.0 / torch.clamp_min(mse, 1e-10))
        tokens = vae.encode_tokens(p, img)
        counts = torch.bincount(tokens.reshape(-1).long(), minlength=cfg.num_tokens).float()
        counts = global_sum(counts)
        probs = counts / torch.clamp_min(counts.sum(), 1.0)
        entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs), 0.0))
        ffd = frechet_feature_distance(vae.encoder_features(p, img),
                                       vae.encoder_features(p, recon),
                                       group=group, replicas=replicas)
        # shares: the trainer sums each over the replicas
        return loss / replicas, {
            "psnr": psnr / replicas,
            "codebook_perplexity": torch.exp(entropy) / replicas,
            "frechet_feature_distance": ffd / replicas,
        }

    return vae, vae.init, train_loss, eval_loss


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


def make_dalle_models(params: Mapping[str, Any], device: torch.device | str, mesh=None):
    """DALLE config (with ``vae_params`` nested, as fetch_model_params
    loads it) -> (dalle, vae) on ``device``; the DALLE on ``mesh`` (its
    blocks on a tensor-parallel one), the VAE whole: the JAX package
    shards only the DALLE's tree by the layout and hands the frozen VAE to
    the step as it is, so a rule on the VAE's dims splits nothing of it."""
    cfg, vae_cfg = _configs(params)
    return DALLE(cfg, device, mesh), DiscreteVAE(vae_cfg, device)


def make_dalle_task(params: Mapping[str, Any], device: torch.device | str, mesh=None):
    """Returns (dalle, vae, init_fn, train_loss_fn, eval_loss_fn).

    ``init_fn(generator)`` draws the fp32 parameter tree. The loss functions
    take (params, frozen_params, batch, generator, step) with a batch of
    torch tensors on the device and return (scalar loss, aux dict);
    ``frozen_params`` is the VAE's tree (image batches) or None (tokens
    batches). On a ``mesh`` the batch holds this rank's rows (the ranks of
    one sequence-parallel or tensor-parallel group encode the same rows),
    and every value returned is this rank's share of the global mean (the
    trainer sums them over the mesh's replicas); ``init_fn`` draws this
    rank's blocks of the parameters (``dalle.sharding``)."""
    cfg, vae_cfg = _configs(params)
    dalle = DALLE(cfg, device, mesh)
    vae = DiscreteVAE(vae_cfg, device)
    z_loss = params.get("z_loss") or 0.0
    fused_xent = bool(params.get("fused_xent"))
    text_len = cfg.text_seq_len

    def tokens_of(frozen_vae, batch):
        if "tokens" in batch:
            # record ids are raw codebook ids (data/encode_dataset.py); the
            # text-vocab offset applies here in both modes
            img_tokens = batch["tokens"].long()
        elif frozen_vae is None:
            raise ValueError("image batches need the frozen VAE's parameters (frozen_params)")
        else:
            # no_grad is JAX's stop_gradient (not inference_mode: the
            # embedding's backward saves these ids)
            with torch.no_grad():
                img_tokens = vae.encode_tokens(frozen_vae, _image(batch)).long()
        return torch.cat([batch["caption"].long(), img_tokens + cfg.text_vocab_size], dim=1)

    def _split_losses(loss_batch, rows):
        # loss_batch[:, i] scores the prediction of token i+1, so image
        # modeling starts at position text_seq_len - 1
        return {
            "loss_text": dalle.global_mean(loss_batch, 0, text_len - 1, rows),
            "loss_image": dalle.global_mean(loss_batch, text_len - 1, rows=rows),
        }

    def train_loss(p, frozen, batch, generator, step):
        tokens = tokens_of(frozen, batch)
        loss, loss_batch = dalle.loss(p, tokens, generator, train=True, z_loss=z_loss,
                                      fused_xent=fused_xent)
        return loss, _split_losses(loss_batch, tokens.shape[0])

    def eval_loss(p, frozen, batch, generator, step):
        """Loss split plus next-token accuracy (overall and image
        positions), on the fp32 logits of ``forward`` (``DALLE.dense_eval``),
        or streamed over row chunks under ``fused_xent``; over the
        vocabulary's blocks on a tensor-parallel mesh."""
        tokens = tokens_of(frozen, batch)
        evaluate = dalle.fused_eval if fused_xent else dalle.dense_eval
        loss_batch, correct = evaluate(p, tokens, generator, z_loss=z_loss)
        rows = tokens.shape[0]
        return dalle.global_mean(loss_batch, rows=rows), {
            **_split_losses(loss_batch, rows),
            "acc": dalle.global_mean(correct, rows=rows),
            "acc_image": dalle.global_mean(correct, text_len - 1, rows=rows),
        }

    return dalle, vae, dalle.init, train_loss, eval_loss
