"""Phoneme string -> token-id conversion (ref: text_utils.py:9-74).

``TextCleaner`` maps each character of a phonemized string to its dictionary
index, warning about (and skipping) unknown phonemes.  Dictionary loading is
lazy by default and honours the same ``lazy_loading`` config flag as the
reference.
"""

from __future__ import annotations

import logging
from typing import List, Mapping, Optional, Sequence, Union

from .dictionary import (
    DEFAULT_DICTIONARY_PATH,
    lazy_loading_enabled,
    load_phoneme_dictionary,
)

logger = logging.getLogger(__name__)

DEFAULT_DICT_PATH = DEFAULT_DICTIONARY_PATH


class TextCleaner:
    def __init__(
        self,
        word_index_dict_path: Union[str, Mapping[str, int]] = DEFAULT_DICT_PATH,
        dictionary_config: Optional[Mapping] = None,
    ):
        self._config = dictionary_config
        self._source = word_index_dict_path
        self._table: Optional[dict] = None
        self._inverse: Optional[dict] = None

        if isinstance(word_index_dict_path, Mapping):
            self._table = dict(word_index_dict_path)
        elif not lazy_loading_enabled(dictionary_config):
            self._table = load_phoneme_dictionary(word_index_dict_path, config=dictionary_config)

    def __call__(self, text: Union[str, Sequence[str]]) -> List[int]:
        table = self.word_index_dictionary
        chars = text if isinstance(text, str) else list(text)
        display = text if isinstance(text, str) else "".join(chars)
        indexes: List[int] = []
        for char in chars:
            idx = table.get(char)
            if idx is None:
                logger.warning("Phoneme %r not found in dictionary. Text: %s", char, display)
            else:
                indexes.append(idx)
        return indexes

    @property
    def word_index_dictionary(self) -> dict:
        if self._table is None:
            self._table = load_phoneme_dictionary(self._source, config=self._config)
        return self._table

    @property
    def inverse_mapping(self) -> dict:
        if self._inverse is None:
            self._inverse = {idx: word for word, idx in self.word_index_dictionary.items()}
        return self._inverse

    @property
    def pad_index(self) -> int:
        return self.word_index_dictionary.get("$", 0)
