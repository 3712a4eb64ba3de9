"""Convert reference PyTorch checkpoints (``pileup.pt`` / ``full_alignment.pt``,
plain ``torch.save(state_dict)`` files, see reference clair3/CallVariants.py:54-63)
into clair3_tpu_torch flax variable trees, so trained reference models run unchanged.

Layout mapping:
* torch ``nn.LSTM`` per direction: ``weight_ih_l0 [4H, C]`` -> ``wi [C, 4H]``
  (transposed), ``weight_hh_l0 [4H, H]`` -> ``wh [H, 4H]``, and the two bias
  vectors fold into one ``b = bias_ih + bias_hh``.  Gate order (i, f, g, o)
  is preserved.  ``_reverse`` suffixed tensors map to the ``bwd`` direction.
* torch ``nn.Conv2d`` ``[O, I, kh, kw]`` -> flax ``[kh, kw, I, O]``.
* torch ``nn.Linear`` ``[out, in]`` -> flax kernel ``[in, out]``.
* torch ``nn.BatchNorm2d`` weight/bias -> scale/bias params; running
  mean/var -> ``batch_stats``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    try:  # torch tensor
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    # strip DDP "module." prefixes
    return {k[len("module."):] if k.startswith("module.") else k: _np(v) for k, v in ckpt.items()}


def _lstm_dir(sd: Dict[str, np.ndarray], prefix: str, suffix: str) -> Dict[str, np.ndarray]:
    wi = sd[f"{prefix}.weight_ih_l0{suffix}"].T.copy()
    wh = sd[f"{prefix}.weight_hh_l0{suffix}"].T.copy()
    b = sd[f"{prefix}.bias_ih_l0{suffix}"] + sd[f"{prefix}.bias_hh_l0{suffix}"]
    return {"wi": wi, "wh": wh, "b": b}


def _dense(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": sd[f"{prefix}.weight"].T.copy(), "bias": sd[f"{prefix}.bias"]}


def _conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0).copy()}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


def pileup_variables_from_torch(sd: Dict[str, np.ndarray]) -> Dict:
    """Build flax variables for PileupNet from a Clair3_P state_dict."""
    params: Dict = {
        "LSTM1": {"fwd": _lstm_dir(sd, "LSTM1", ""), "bwd": _lstm_dir(sd, "LSTM1", "_reverse")},
        "LSTM2": {"fwd": _lstm_dir(sd, "LSTM2", ""), "bwd": _lstm_dir(sd, "LSTM2", "_reverse")},
        "L4": _dense(sd, "L4"),
        "L5_1": _dense(sd, "L5_1"),
        "L5_2": _dense(sd, "L5_2"),
        "Y_gt21_logits": _dense(sd, "Y_gt21_logits"),
        "Y_genotype_logits": _dense(sd, "Y_genotype_logits"),
    }
    add_indel_length = "L5_3.weight" in sd
    if add_indel_length:
        params["L5_3"] = _dense(sd, "L5_3")
        params["L5_4"] = _dense(sd, "L5_4")
        params["Y_indel_length_logits_1"] = _dense(sd, "Y_indel_length_logits_1")
        params["Y_indel_length_logits_2"] = _dense(sd, "Y_indel_length_logits_2")
    return {"params": params}


def _conv_bn_relu(sd, torch_prefix: str) -> Tuple[Dict, Dict]:
    conv = _conv(sd, f"{torch_prefix}.conv")
    bn_p, bn_s = _bn(sd, f"{torch_prefix}.bn")
    return {"conv": conv, "bn": bn_p}, {"bn": bn_s}


def _res_block(sd, torch_prefix: str) -> Tuple[Dict, Dict]:
    # reference wraps each block in nn.Sequential -> ".0." index
    p = f"{torch_prefix}.0"
    conv1 = _conv(sd, f"{p}.conv1")
    conv2 = _conv(sd, f"{p}.conv2")
    bn1_p, bn1_s = _bn(sd, f"{p}.bn1")
    bn2_p, bn2_s = _bn(sd, f"{p}.bn2")
    return (
        {"conv1": conv1, "bn1": bn1_p, "conv2": conv2, "bn2": bn2_p},
        {"bn1": bn1_s, "bn2": bn2_s},
    )


def full_alignment_variables_from_torch(sd: Dict[str, np.ndarray]) -> Dict:
    """Build flax variables for FullAlignmentNet from a Clair3_F state_dict."""
    params: Dict = {}
    stats: Dict = {}
    for name in ("conv1", "conv3", "conv5"):
        params[name], stats[name] = _conv_bn_relu(sd, name)
    for name in ("res_block1", "res_block2", "res_block3"):
        params[name], stats[name] = _res_block(sd, name)
    for name in ("L4", "L5_1", "L5_2", "Y_gt21_logits", "Y_genotype_logits"):
        params[name] = _dense(sd, name)
    if "L5_3.weight" in sd:
        for name in ("L5_3", "L5_4", "Y_indel_length_logits_1", "Y_indel_length_logits_2"):
            params[name] = _dense(sd, name)
    return {"params": params, "batch_stats": stats}


class _TrackingDict(dict):
    """State-dict wrapper recording which keys the converter consumed."""

    def __init__(self, d):
        super().__init__(d)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


# keys that are legitimately unused by inference
_IGNORABLE = ("num_batches_tracked",)


def convert_checkpoint(path: str, kind: str, strict: bool = True) -> Dict:
    """kind: 'pileup' | 'full_alignment'.

    With ``strict`` (default), the state dict is first validated against
    the reference architecture's key/shape manifest (models/schema.py) so a
    published ``.pt`` with an unexpected prefix, a missing tensor, or a
    wrong shape fails with ONE aggregated, actionable message at the user's
    first run; afterwards every tensor must also be consumed by the layout
    mapping (BatchNorm ``num_batches_tracked`` counters aside) — a
    checkpoint either loads completely or fails loudly instead of silently
    dropping weights."""
    sd = _TrackingDict(load_torch_state_dict(path))
    if strict:
        from clair3_tpu_torch.models.schema import validate_state_dict

        # plain-dict copy: validation reads every tensor and must not mark
        # keys as consumed for the post-conversion unused check
        problems = validate_state_dict(dict(sd), kind)
        if problems:
            shown = "\n  ".join(problems[:12])
            more = f"\n  ... and {len(problems) - 12} more" \
                if len(problems) > 12 else ""
            raise ValueError(
                f"{path} does not conform to the reference {kind} "
                f"checkpoint schema ({len(problems)} problem(s)):\n"
                f"  {shown}{more}\n"
                "(expected a Clair3_P/Clair3_F torch state_dict, optionally "
                "{'state_dict': ...}-wrapped and/or 'module.'-prefixed)")
    if kind == "pileup":
        out = pileup_variables_from_torch(sd)
    elif kind == "full_alignment":
        out = full_alignment_variables_from_torch(sd)
    else:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    if strict:
        unused = [k for k in sd if k not in sd.used
                  and not k.endswith(_IGNORABLE)]
        if unused:
            raise ValueError(
                f"{path}: {len(unused)} checkpoint tensors not consumed by "
                f"the {kind} layout mapping: {sorted(unused)[:10]}...")
    return out


def main(argv=None) -> int:
    """Offline .pt -> .npz conversion:
    ``python -m clair3_tpu_torch.models.convert <in.pt> <out.npz> [kind]``
    (kind defaults from the input filename: pileup / full_alignment)."""
    import argparse
    import os

    from clair3_tpu_torch.models.params_io import save_variables

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("kind", nargs="?", default=None,
                    choices=("pileup", "full_alignment"))
    args = ap.parse_args(argv)
    kind = args.kind
    if kind is None:
        base = os.path.basename(args.src)
        kind = "pileup" if "pileup" in base else "full_alignment"
    save_variables(args.dst, convert_checkpoint(args.src, kind))
    print(f"[convert] {args.src} ({kind}) -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
