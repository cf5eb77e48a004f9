from .dictionary import (
    DEFAULT_DICTIONARY_PATH,
    load_phoneme_dictionary,
    resolve_phoneme_dictionary_settings,
    infer_phoneme_dictionary_token_count,
)
from .cleaner import TextCleaner

__all__ = [
    "DEFAULT_DICTIONARY_PATH",
    "load_phoneme_dictionary",
    "resolve_phoneme_dictionary_settings",
    "infer_phoneme_dictionary_token_count",
    "TextCleaner",
]
