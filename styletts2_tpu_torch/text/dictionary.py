"""Phoneme-to-index dictionary loading.

Functional parity with the reference subsystem (ref: phoneme_dictionary.py:63-255):
CSV ``"phoneme",index`` files, a process-local cache, lazy-loading flags, and
source resolution with the precedence  data_params override > ASR-config
``phoneme_maps_path`` > packaged default.

The packaged default table (``data/word_index_dict.txt``) is byte-identical to
the reference's ``Data/word_index_dict.txt`` so that token ids line up with
published checkpoints.  Its parse quirks are deliberately preserved: the CSV
escape ``\"\"\"\"`` collapses to an empty-string key, index 174 is absent, and
``¡`` appears at both 7 and 178 (the last entry wins).
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple, Union


DictionaryLike = Mapping[str, int]

DEFAULT_DICTIONARY_PATH = os.path.join(os.path.dirname(__file__), "data", "word_index_dict.txt")

_CACHE: Dict[str, Dict[str, int]] = {}
_CACHE_LOCK = threading.RLock()


def _flag(config: Optional[Mapping], key: str, default: bool) -> bool:
    """Read a boolean flag that may be spelled ``{key: bool}`` or ``{key: {enabled: bool}}``."""
    if not isinstance(config, Mapping):
        return default
    section = config.get(key)
    if isinstance(section, Mapping):
        return bool(section.get("enabled", default))
    if isinstance(section, bool):
        return section
    return default


def lazy_loading_enabled(config: Optional[Mapping]) -> bool:
    return _flag(config, "lazy_loading", True)


def _parse_csv(path: str, restore_space_entry: bool = False) -> Dict[str, int]:
    table: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8", newline="") as handle:
        for row in csv.reader(handle):
            if len(row) < 2:
                continue
            raw = row[0]
            phoneme = raw.strip()
            if phoneme.startswith('"') and phoneme.endswith('"'):
                phoneme = phoneme[1:-1]
            try:
                index = int(row[1])
            except ValueError:
                continue
            # Reference parity: ``.strip()`` collapses the quoted-space row to
            # the empty string, so the default table has no ' ' key and the
            # empty string maps to 16 (ref: phoneme_dictionary.py:63-83).
            if restore_space_entry and phoneme == "" and raw != phoneme and raw.strip('"') == " ":
                phoneme = " "
            table[phoneme] = index
    return table


def load_phoneme_dictionary(
    source: Union[str, DictionaryLike],
    config: Optional[Mapping] = None,
) -> Dict[str, int]:
    """Load a phoneme dictionary from a mapping or a CSV file path.

    ``config['restore_space_entry']`` (default False) re-instates the quoted
    space row that the reference parser loses — useful with upstream
    (yl4579) checkpoints whose token streams contain spaces.
    """
    if isinstance(source, Mapping):
        return dict(source)

    restore_space = bool(config.get("restore_space_entry", False)) if isinstance(config, Mapping) else False
    path = os.path.abspath(str(source))
    if not lazy_loading_enabled(config):
        return _parse_csv(path, restore_space)

    cache_key = (path, restore_space)
    with _CACHE_LOCK:
        cached = _CACHE.get(cache_key)
        if cached is None:
            cached = _CACHE[cache_key] = _parse_csv(path, restore_space)
        return dict(cached)


def infer_phoneme_dictionary_token_count(
    source: Union[str, DictionaryLike, None],
    config: Optional[Mapping] = None,
) -> Optional[int]:
    """Vocabulary size implied by the dictionary: max index + 1 (ref: phoneme_dictionary.py:116-156)."""
    if source is None:
        return None
    try:
        table = load_phoneme_dictionary(source, config=config)
    except FileNotFoundError:
        return None

    indices = []
    for value in table.values():
        try:
            indices.append(int(value))
        except (TypeError, ValueError):
            continue
    if not indices or max(indices) < 0:
        return None
    return max(indices) + 1


def _get_nested(cfg: Any, dotted: str, default=None):
    current = cfg
    for key in dotted.split("."):
        if isinstance(current, Mapping) and key in current:
            current = current[key]
        else:
            return default
    return current


def _deep_merge(base: Mapping, overrides: Mapping) -> Dict:
    merged = dict(base)
    for key, value in (overrides or {}).items():
        if isinstance(value, Mapping) and isinstance(merged.get(key), Mapping):
            merged[key] = _deep_merge(merged[key], value)
        else:
            merged[key] = value
    return merged


def _resolve_relative(path, base_dir: Optional[str]):
    if not isinstance(path, str):
        return path
    expanded = os.path.expanduser(path)
    if os.path.isabs(expanded):
        return expanded
    if base_dir:
        candidate = os.path.abspath(os.path.join(base_dir, expanded))
        if os.path.exists(candidate):
            return candidate
    return expanded


def resolve_phoneme_dictionary_settings(
    data_params: Optional[Mapping[str, Any]] = None,
    asr_config_path: Optional[str] = None,
    default_path: Union[str, DictionaryLike, None] = DEFAULT_DICTIONARY_PATH,
) -> Tuple[Union[str, DictionaryLike, None], Dict[str, Any]]:
    """Resolve (dictionary_source, dictionary_config) with the reference precedence
    (ref: phoneme_dictionary.py:200-255): data_params['phoneme_dict_path' | 'dict_path']
    overrides the ASR config's ``phoneme_maps_path``, which overrides ``default_path``.
    """
    source: Union[str, DictionaryLike, None] = None
    dict_config: Dict[str, Any] = {}
    config_dir: Optional[str] = None

    if asr_config_path:
        import yaml

        try:
            with open(asr_config_path, "r", encoding="utf-8") as handle:
                asr_cfg = yaml.safe_load(handle) or {}
        except FileNotFoundError:
            asr_cfg = {}
        config_dir = os.path.dirname(os.path.abspath(asr_config_path))
        section = _get_nested(asr_cfg, "phoneme_dictionary", {}) or {}
        if isinstance(section, Mapping):
            dict_config = dict(section)
        source = _resolve_relative(_get_nested(asr_cfg, "phoneme_maps_path"), config_dir)

    if isinstance(data_params, Mapping):
        override = data_params.get("phoneme_dict_path", data_params.get("dict_path"))
        if override is not None:
            source = _resolve_relative(override, config_dir)
        override_cfg = data_params.get("phoneme_dictionary_config")
        if isinstance(override_cfg, Mapping):
            dict_config = _deep_merge(dict_config, override_cfg)

    if source is None:
        source = default_path
    return source, dict_config
