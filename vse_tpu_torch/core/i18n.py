"""Message catalog (the port of ``vse_tpu/core/i18n.py``).

The reference ships 8 UI locales as .ini files (reference
backend/interface/*.ini) loaded through ConfigParser (reference
backend/config.py:104-108). The port's user-facing pipeline messages go
through the same keyed catalog, with its own copy of the JAX package's
eight catalogs under ``vse_tpu_torch/assets/locales/``.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict, Optional

# Keys mirror the reference's [Main] message keys (backend/interface/en.ini).
_EN: Dict[str, str] = {
    "OcrResult": "[OCR] {0} (confidence {1}%)",
    "OcrResultWithDropReason": "[OCR-dropped] {0} (confidence {1}%) — {2}",
    "OcrDropNoIntercetion": "outside the subtitle area",
    "OcrDropOutOfBoxRate": "overflow {1}% exceeds the allowed {0}%",
    "OcrDropConfidentLow": "confidence below {0}%",
    "SubLocation": "subtitle file saved: {0}",
    "WatchPicture": "review the marked frame",
    "QuestionDelete": "{0} appears {1}x — delete this area's text? [y/n] ",
    "FinishDelete": "deleted",
    "FinishWaterMarkFilter": "watermark filtering finished",
    "CheckSubArea": "check the subtitle area preview:",
    "DeleteNoSubArea": "keep only lines inside y band {0}? [y/n] ",
    "FinishDeleteNoSubArea": "done",
    "ResumeFrom": "resuming from frame {0} ({1} records restored)",
    "ExtractionDone": "extraction finished in {0}s -> {1}",
}

_catalog: Dict[str, str] = dict(_EN)
_locale = "en"


def _locales_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "locales",
    )


def available_locales() -> list:
    """Bundled locale catalogs (the reference ships 8:
    ch/chinese_cht/en/es/japan/ko/tr/vi — backend/interface/*.ini)."""
    d = _locales_dir()
    if not os.path.isdir(d):
        return ["en"]
    return sorted(f[:-4] for f in os.listdir(d) if f.endswith(".ini"))


def _load_ini(ini_path: str) -> Dict[str, str]:
    # interpolation=None: messages contain literal '%' (confidence values),
    # which BasicInterpolation would reject at access time
    cp = configparser.ConfigParser(interpolation=None)
    cp.optionxform = str  # keep CamelCase keys (ConfigParser lowercases)
    cp.read(ini_path, encoding="utf-8")
    return dict(cp["Main"]) if cp.has_section("Main") else {}


def set_locale(locale: str, ini_path: Optional[str] = None) -> None:
    """Switch catalogs; unknown keys fall back to English (the reference
    loads en.ini first, then the selected locale, backend/config.py:22-25).

    Without an explicit `ini_path`, the bundled catalog
    vse_tpu_torch/assets/locales/<locale>.ini is used when present."""
    global _catalog, _locale
    _catalog = dict(_EN)
    _locale = locale
    if ini_path is None:
        ini_path = os.path.join(_locales_dir(), f"{locale}.ini")
    if ini_path and os.path.exists(ini_path):
        _catalog.update(_load_ini(ini_path))


def get_locale() -> str:
    return _locale


def tr(key: str, *args) -> str:
    msg = _catalog.get(key, key)
    try:
        return msg.format(*args)
    except (IndexError, KeyError):
        return msg
