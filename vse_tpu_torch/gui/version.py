"""Version service: local version + release update check.

Mirrors the reference's GitHub-releases checker (reference
backend/tools/version_service.py:12-83): query the releases-latest API on
the primary endpoint, fall back to a mirror, honor the system proxy
(env), compare semver-ish tags. Zero-egress environments get a clean
{"status": "offline"} instead of an exception.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Dict, List

VERSION = "0.1.0"  # keep in sync with pyproject.toml
PROJECT_HOME_URL = "https://github.com/YaoFANGUK/video-subtitle-extractor"
UPDATE_URLS: List[str] = [
    "https://api.github.com/repos/YaoFANGUK/video-subtitle-extractor/releases/latest",
    "https://accelerate.xdow.net/api/repos/YaoFANGUK/video-subtitle-extractor/releases/latest",
]


def _version_tuple(tag: str):
    parts = []
    for tok in tag.lstrip("vV").split("."):
        digits = "".join(c for c in tok if c.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def check_updates(timeout: float = 5.0) -> Dict:
    """Try each mirror in order (reference iterates PROJECT_UPDATE_URLS);
    system proxy comes from the standard env vars via urllib's default
    opener (reference discovers the system proxy explicitly)."""
    for url in UPDATE_URLS:
        try:
            req = urllib.request.Request(
                url, headers={"User-Agent": "vse-tpu", "Accept": "application/json"}
            )
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = json.loads(resp.read().decode("utf-8"))
            tag = data.get("tag_name", "")
            return {
                "status": "ok",
                "current": VERSION,
                "latest": tag,
                "update_available": _version_tuple(tag) > _version_tuple(VERSION),
                "url": data.get("html_url", PROJECT_HOME_URL),
            }
        except (urllib.error.URLError, OSError, ValueError, json.JSONDecodeError):
            continue
    return {"status": "offline", "current": VERSION}


def info() -> Dict:
    return {
        "version": VERSION,
        "home": PROJECT_HOME_URL,
        "proxy": os.environ.get("https_proxy") or os.environ.get("HTTPS_PROXY") or "",
    }
