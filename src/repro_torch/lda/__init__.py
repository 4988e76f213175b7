from repro_torch.lda.api import FrozenLDAModel, LDAEngine
from repro_torch.lda.corpus import (Corpus, from_documents, pad_corpus,
                                    planted_corpus, relabel_by_frequency,
                                    synthetic_lda_corpus, zipf_corpus)
from repro_torch.lda.model import LDAConfig, LDAState
from repro_torch.lda.trainer import LDATrainer
