from .annotations import construct_instrs, load_instr_datasets
from .features import (ImageFeatureStore, HashFeatureStore,
                       ObjectFeatureStore, HashObjectStore)
from .tokenizer import get_tokenizer, HashTokenizer
