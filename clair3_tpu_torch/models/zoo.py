"""Registry of the reference's published pretrained checkpoints.

The reference ships/links pretrained model directories whose *names* carry
configuration the pipeline must react to (reference README.md:405-449 model
tables; run_clair3.py:323-326 bumps ``var_pct_phasing`` to 0.8 for the
Guppy5 models; README issue #437 asks for a clear early failure when a
signal-aware ``*_with_mv`` model is run without ``--enable_dwell_time``).

This module is that knowledge as data: ``lookup_model`` resolves a
``--model_path`` directory to a :class:`ModelInfo`, and the ``call`` CLI
uses it to (a) fail early on a platform/model mismatch with actionable
guidance, (b) apply the model-keyed ``var_pct_phasing`` default, and
(c) announce the dwell channel for ``*_with_mv`` models up front (the
engine still reconciles from the loaded conv width afterwards, which
covers unknown/self-trained names).

Checkpoints themselves are the reference's ``.pt`` files (or our ``.npz``);
``models/convert.py`` loads either — see docs/pretrained_models.md.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ModelInfo:
    name: str
    platform: str                       # ont | hifi | ilmn
    description: str
    dwell: bool = False                 # *_with_mv: needs the dwell channel
    var_pct_phasing: Optional[float] = None  # model-keyed override
    source: str = "hku-bal"             # hku-bal | rerio | legacy


def _ont(name: str, desc: str, **kw) -> ModelInfo:
    return ModelInfo(name=name, platform="ont", description=desc, **kw)


_MODELS = [
    # --- HKU-BAL pretrained (reference README.md:405-413) ---------------
    _ont("r1041_e82_400bps_hac_v600_with_mv",
         "ONT R10.4.1 E8.2 (5 kHz), Dorado v6.0.0 HAC, signal-aware",
         dwell=True),
    _ont("r1041_e82_400bps_hac_v520_with_mv",
         "ONT R10.4.1 E8.2 (5 kHz), Dorado v5.2.0 HAC, signal-aware",
         dwell=True),
    _ont("r1041_e82_400bps_sup_v520_with_mv",
         "ONT R10.4.1 E8.2 (5 kHz), Dorado v5.2.0 SUP, signal-aware",
         dwell=True),
    _ont("r941_prom_sup_g5014",
         "ONT R9.4.1, Guppy5 SUP (also for HAC/fast reads)",
         var_pct_phasing=0.8),
    _ont("r941_prom_hac_g5014",
         "ONT R9.4.1, Guppy5 HAC",
         var_pct_phasing=0.8),
    _ont("r941_prom_hac_g360+g422", "ONT R9.4.1, Guppy3/4 HAC"),
    _ont("r941_prom_sup_g506", "ONT R9.4.1, Guppy5 SUP (obsoleted by g5014)",
         source="legacy"),
    _ont("r941_prom_hac_g238", "ONT R9.4.1, Guppy2 (Guppy2-or-earlier data)",
         source="legacy"),
    _ont("ont_guppy5", "legacy alias for the Guppy5 model",
         var_pct_phasing=0.8, source="legacy"),
    _ont("ont_guppy2", "legacy alias for the Guppy2 model", source="legacy"),
    _ont("r1041_e82_400bps_sup_v430_bacteria_finetuned",
         "ONT R10.4.1 SUP v4.3.0, fine-tuned on 12 bacterial genomes"),
    ModelInfo("hifi_revio", "hifi", "PacBio HiFi Revio"),
    ModelInfo("hifi_sequel2", "hifi", "PacBio HiFi Sequel II"),
    ModelInfo("hifi", "hifi", "legacy alias for the Sequel II model",
              source="legacy"),
    ModelInfo("ilmn", "ilmn", "Illumina (PE100/PE150)"),
    # --- Rerio-converted, ONT-trained (reference README.md:425-449) -----
    _ont("r1041_e82_400bps_hac_v600", "Rerio: Dorado v6.0.0 HAC",
         source="rerio"),
    _ont("r1041_e82_400bps_sup_v520", "Rerio: Dorado v5.2.0 SUP",
         source="rerio"),
    _ont("r1041_e82_400bps_hac_v520", "Rerio: Dorado v5.2.0 HAC",
         source="rerio"),
    _ont("r1041_e82_400bps_sup_v500", "Rerio: Dorado v5.0.0 SUP",
         source="rerio"),
    _ont("r1041_e82_400bps_hac_v500", "Rerio: Dorado v5.0.0 HAC",
         source="rerio"),
    _ont("r1041_e82_400bps_sup_v430", "Rerio: Dorado v4.3.0 SUP",
         source="rerio"),
    _ont("r1041_e82_400bps_hac_v430", "Rerio: Dorado v4.3.0 HAC",
         source="rerio"),
    _ont("r1041_e82_400bps_sup_v410", "Rerio: Dorado v4.1.0 SUP",
         source="rerio"),
    _ont("r1041_e82_400bps_hac_v410", "Rerio: Dorado v4.1.0 HAC",
         source="rerio"),
]

MODEL_ZOO: Dict[str, ModelInfo] = {m.name: m for m in _MODELS}


def lookup_model(model_path: str) -> Optional[ModelInfo]:
    """Resolve a ``--model_path`` directory (or bare name) to its registry
    entry; None for self-trained / unknown names (which stay fully
    supported — the engine reconciles dwell from the checkpoint itself)."""
    if not model_path:
        return None
    name = os.path.basename(os.path.normpath(model_path))
    return MODEL_ZOO.get(name)


def name_implies_dwell(model_path: str) -> bool:
    """Name-based move-table detection for *unknown* (self-trained) model
    directories: the reference treats any model name containing
    ``with_mv``/``with_move`` as signal-aware (run_clair3.py:414-418), not
    just registry entries — mirror that so unknown ``*_with_mv`` dirs get
    the same early announce / mv-tag probe as registry models."""
    if not model_path:
        return False
    name = os.path.basename(os.path.normpath(model_path)).lower()
    return "with_mv" in name or "with_move" in name


def validate_model_choice(info: ModelInfo, platform: str) -> Optional[str]:
    """Fail-early check (reference issue #437 spirit): returns an error
    string on a platform/model mismatch, else None."""
    if info.platform != platform:
        return (
            f"model '{info.name}' is a --platform {info.platform} model "
            f"({info.description}) but --platform {platform} was given; "
            f"pass --platform {info.platform}, or pick a {platform} model "
            "(see docs/pretrained_models.md)")
    return None


def format_zoo_table() -> str:
    """Human-readable registry listing for the `models` subcommand."""
    rows = [("NAME", "PLATFORM", "DWELL", "SOURCE", "DESCRIPTION")]
    for m in _MODELS:
        rows.append((m.name, m.platform, "yes" if m.dwell else "-",
                     m.source, m.description))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    return "\n".join(
        "  ".join(c.ljust(widths[i]) for i, c in enumerate(r[:4])) + "  " + r[4]
        for r in rows)
