"""Config system (copy of ``dalle_mtf_tpu/utils/config.py``).

Keeps the reference's user surface: JSON files in ./configs/<name>.json with
missing keys reading as None (reference: src/utils/utils.py:13-17 loads into a
``defaultdict(lambda: None)``), and DALLE configs composing a nested VAE config
via the ``"vae_model"`` key (reference: train_dalle.py:31).

Copied rather than imported: importing anything under ``dalle_mtf_tpu``
runs that package's ``__init__``, which imports JAX.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping


class Config(dict):
    """A dict whose missing keys read as ``None``.

    Mirrors the reference's ``defaultdict(lambda: None)`` semantics
    (src/utils/utils.py:16, src/dalle_mtf/models.py:182-184) so model code can
    probe optional hyperparameters without sprinkling ``.get`` everywhere —
    while still being JSON-serializable.
    """

    def __missing__(self, key: str) -> None:  # noqa: D105
        return None

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "Config":
        out = cls()
        for k, v in m.items():
            if isinstance(v, Mapping):
                v = cls.from_mapping(v)
            out[k] = v
        return out

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out


def _resolve_config_path(model: str, configs_dir: str | None = None) -> str:
    """Resolve a model name or path to a JSON config file.

    Accepts either a bare name (looked up under ``configs/``, reference
    utils.py:14) or a direct path to a ``.json`` file (the reference's
    ``vae_model`` key accepts "path to or name of vae model config",
    README.md:166).
    """
    if os.path.isfile(model):
        return model
    name = model if model.endswith(".json") else model + ".json"
    search = []
    if configs_dir:
        search.append(os.path.join(configs_dir, name))
    search.append(os.path.join("configs", name))
    # configs/ next to the repo root that contains this package, so CLIs work
    # from any CWD.
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    search.append(os.path.join(pkg_root, "configs", name))
    for path in search:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"config {model!r} not found (searched: {search})"
    )


def fetch_model_params(model: str, configs_dir: str | None = None) -> Config:
    """Load ``configs/<model>.json`` into a Config (missing keys -> None).

    If the config is a DALLE config (has ``vae_model``), the named VAE config
    is loaded and nested under ``params["vae_params"]`` exactly like
    train_dalle.py:30-31 in the reference.
    """
    path = _resolve_config_path(model, configs_dir)
    with open(path) as f:
        params = Config.from_mapping(json.load(f))
    params["config_name"] = os.path.splitext(os.path.basename(path))[0]
    if params["vae_model"]:
        vae_path = _resolve_config_path(params["vae_model"], configs_dir)
        with open(vae_path) as f:
            params["vae_params"] = Config.from_mapping(json.load(f))
        params["vae_params"]["config_name"] = os.path.splitext(
            os.path.basename(vae_path)
        )[0]
    return params


def image_seq_len(vae_params: Mapping[str, Any]) -> int:
    """Number of image tokens the VAE produces for one image:
    (H / 2^num_blocks)^2 / stack_factor^2 (reference: src/model_fns.py:68)."""
    from dalle_mtf_tpu_torch.models.vae import VAEConfig  # noqa: PLC0415

    return VAEConfig.from_params(vae_params).image_seq_len
