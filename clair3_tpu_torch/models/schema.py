"""Key/shape manifests for the reference's published ``.pt`` checkpoints.

The reference serves every pretrained model as a plain
``torch.save(state_dict)`` file (reference clair3/CallVariants.py:54-63),
sometimes wrapped as ``{"state_dict": ...}`` and sometimes carrying DDP
``module.`` prefixes (both handled by ``convert.load_torch_state_dict``).
The tensor names and shapes are fully determined by the architecture code:

* ``Clair3_P`` (reference clair3/model.py:58-161): two bidirectional LSTMs
  (128 then 160 hidden units, model.py:46-47), ``L4`` of
  ``160*2*33 -> 128`` (``L4_pileup_num_units``, model.py:36,110), two
  (or four with ``--add_indel_length``) 128-unit ``L5_*`` branches and
  their logits heads (21 / 3 / 33 / 33 labels).  The pileup stage runs
  WITHOUT ``--add_indel_length`` (reference scripts/clair3.sh pileup call),
  so published pileup checkpoints have 2 heads.
* ``Clair3_F`` (reference clair3/model.py:282-416): three stride-2
  ``BasicConv2D`` stages (64/128/256) each followed by one ``BasicBlock``
  wrapped in ``nn.Sequential`` (-> ``res_blockN.0.`` key prefix,
  model.py:238-242), pyramid pooling to 14*256=3584 features, ``L4`` of
  ``3584 -> 256``, four 128-unit head branches (the FA stage always passes
  ``--add_indel_length``, reference scripts/clair3.sh:301).  Signal-aware
  ``*_with_mv`` models add the dwell channel: ``input_channels`` 9
  instead of 8 (reference run_clair3.py:414-430).

``validate_state_dict`` checks a loaded state dict against the manifest
BEFORE layout conversion, so a checkpoint with an unexpected key, a missing
tensor, or a wrong shape fails with one aggregated, actionable message at
the user's first run instead of a KeyError mid-conversion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from clair3_tpu_torch.config import (
    GT21_LABEL_COUNT,
    GENOTYPE_LABEL_COUNT,
    VARIANT_LENGTH_LABEL_COUNT,
    PILEUP_CHANNEL_SIZE,
    FA_CHANNEL_SIZE,
    NO_OF_POSITIONS,
)

# reference clair3/model.py:35-47
_LSTM1_UNITS = 128
_LSTM2_UNITS = 160
_L4_PILEUP_UNITS = 128
_L4_FA_UNITS = 256
_L5_UNITS = 128
_FA_POOLED = 14 * 256  # PyramidPolling (3,2,1): (9+4+1)*256, model.py:246-279

_HEAD_SIZES = {
    "Y_gt21_logits": GT21_LABEL_COUNT,
    "Y_genotype_logits": GENOTYPE_LABEL_COUNT,
    "Y_indel_length_logits_1": VARIANT_LENGTH_LABEL_COUNT,
    "Y_indel_length_logits_2": VARIANT_LENGTH_LABEL_COUNT,
}

Shape = Tuple[int, ...]


def _linear(schema: Dict[str, Shape], name: str, n_in: int, n_out: int) -> None:
    schema[f"{name}.weight"] = (n_out, n_in)
    schema[f"{name}.bias"] = (n_out,)


def _lstm(schema: Dict[str, Shape], name: str, n_in: int, hidden: int) -> None:
    for suffix in ("", "_reverse"):
        schema[f"{name}.weight_ih_l0{suffix}"] = (4 * hidden, n_in)
        schema[f"{name}.weight_hh_l0{suffix}"] = (4 * hidden, hidden)
        schema[f"{name}.bias_ih_l0{suffix}"] = (4 * hidden,)
        schema[f"{name}.bias_hh_l0{suffix}"] = (4 * hidden,)


def _conv(schema: Dict[str, Shape], name: str, n_in: int, n_out: int,
          k: int = 3) -> None:
    schema[f"{name}.weight"] = (n_out, n_in, k, k)
    schema[f"{name}.bias"] = (n_out,)


def _bn(schema: Dict[str, Shape], name: str, n: int) -> None:
    schema[f"{name}.weight"] = (n,)
    schema[f"{name}.bias"] = (n,)
    schema[f"{name}.running_mean"] = (n,)
    schema[f"{name}.running_var"] = (n,)
    # scalar counter, optional in validation (ignored by conversion)
    schema[f"{name}.num_batches_tracked"] = ()


def _heads(schema: Dict[str, Shape], l4_units: int,
           add_indel_length: bool) -> None:
    names = ["Y_gt21_logits", "Y_genotype_logits"]
    if add_indel_length:
        names += ["Y_indel_length_logits_1", "Y_indel_length_logits_2"]
    for i, head in enumerate(names):
        _linear(schema, f"L5_{i + 1}", l4_units, _L5_UNITS)
        _linear(schema, head, _L5_UNITS, _HEAD_SIZES[head])


def pileup_state_dict_schema(
    add_indel_length: bool = False,
    input_channels: int = PILEUP_CHANNEL_SIZE,
) -> Dict[str, Shape]:
    """Key -> shape manifest of a ``Clair3_P`` ``state_dict``."""
    schema: Dict[str, Shape] = {}
    _lstm(schema, "LSTM1", input_channels, _LSTM1_UNITS)
    _lstm(schema, "LSTM2", 2 * _LSTM1_UNITS, _LSTM2_UNITS)
    _linear(schema, "L4", 2 * _LSTM2_UNITS * NO_OF_POSITIONS, _L4_PILEUP_UNITS)
    _heads(schema, _L4_PILEUP_UNITS, add_indel_length)
    return schema


def full_alignment_state_dict_schema(
    add_indel_length: bool = True,
    input_channels: int = FA_CHANNEL_SIZE,
) -> Dict[str, Shape]:
    """Key -> shape manifest of a ``Clair3_F`` ``state_dict``."""
    schema: Dict[str, Shape] = {}
    chans = [(input_channels, 64), (64, 128), (128, 256)]
    for i, (cin, cout) in enumerate(chans):
        conv = f"conv{2 * i + 1}"
        _conv(schema, f"{conv}.conv", cin, cout)
        _bn(schema, f"{conv}.bn", cout)
        blk = f"res_block{i + 1}.0"  # nn.Sequential wrapper, model.py:238-242
        _conv(schema, f"{blk}.conv1", cout, cout)
        _bn(schema, f"{blk}.bn1", cout)
        _conv(schema, f"{blk}.conv2", cout, cout)
        _bn(schema, f"{blk}.bn2", cout)
    _linear(schema, "L4", _FA_POOLED, _L4_FA_UNITS)
    _heads(schema, _L4_FA_UNITS, add_indel_length)
    return schema


def schema_for(kind: str, add_indel_length: bool,
               input_channels: Optional[int] = None) -> Dict[str, Shape]:
    if kind == "pileup":
        return pileup_state_dict_schema(
            add_indel_length, input_channels or PILEUP_CHANNEL_SIZE)
    if kind == "full_alignment":
        return full_alignment_state_dict_schema(
            add_indel_length, input_channels or FA_CHANNEL_SIZE)
    raise ValueError(f"unknown checkpoint kind {kind!r}")


def infer_config(sd: Dict, kind: str) -> Tuple[bool, int]:
    """(add_indel_length, input_channels) read from a state dict itself —
    the same sniffs the engine loader uses (cli._load_engine), so unknown /
    self-trained checkpoints validate against their own configuration."""
    add_indel = "L5_3.weight" in sd
    if kind == "pileup":
        w = sd.get("LSTM1.weight_ih_l0")
        in_ch = int(w.shape[1]) if w is not None else PILEUP_CHANNEL_SIZE
    else:
        w = sd.get("conv1.conv.weight")
        in_ch = int(w.shape[1]) if w is not None else FA_CHANNEL_SIZE
    return add_indel, in_ch


def validate_state_dict(sd: Dict, kind: str,
                        expect_dwell: Optional[bool] = None) -> List[str]:
    """All conformance problems of ``sd`` vs the reference manifest (empty
    list = conformant).  ``expect_dwell`` cross-checks a ``*_with_mv``
    registry entry against the checkpoint's actual channel count."""
    add_indel, in_ch = infer_config(sd, kind)
    schema = schema_for(kind, add_indel, in_ch)
    problems: List[str] = []
    for key, want in sorted(schema.items()):
        if key.endswith("num_batches_tracked"):
            continue  # optional BN counter
        if key not in sd:
            problems.append(f"missing tensor {key!r} (expected shape {want})")
            continue
        got = tuple(int(d) for d in sd[key].shape)
        if got != want:
            problems.append(f"{key}: shape {got}, manifest says {want}")
    known = set(schema)
    for key in sorted(sd):
        if key not in known and not key.endswith("num_batches_tracked"):
            problems.append(f"unexpected tensor {key!r} "
                            f"(shape {tuple(sd[key].shape)})")
    if kind == "full_alignment" and expect_dwell is not None:
        want_ch = FA_CHANNEL_SIZE + 1 if expect_dwell else FA_CHANNEL_SIZE
        if in_ch != want_ch:
            problems.append(
                f"registry says dwell={expect_dwell} (-> {want_ch} input "
                f"channels) but conv1 has {in_ch}")
    return problems
