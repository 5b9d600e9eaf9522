"""NLP / embeddings tier (port of ``deeplearning4j_tpu/nlp``).

Equivalent of the reference's ``deeplearning4j-nlp-parent`` (SURVEY.md
§2.7): tokenization SPI, sentence/document iterators, vocabulary
construction + Huffman coding, in-memory lookup tables, SequenceVectors /
Word2Vec (skip-gram/CBOW as torch ops, on the host path or the
device-resident corpus pipeline), ParagraphVectors, GloVe, TF-IDF /
bag-of-words, word-vector serde, and the language tools: the Japanese
(dictionary lattice + Viterbi, ``lattice.py``), Korean and UIMA-style
tokenizers of ``lang.py``.
"""

from .tokenization import (CommonPreprocessor, DefaultTokenizerFactory,
                           EndingPreProcessor, LowCasePreProcessor,
                           NGramTokenizerFactory, Tokenizer,
                           TokenizerFactory)
from .sentence_iterator import (BasicLineIterator,
                                CollectionSentenceIterator,
                                FileSentenceIterator, LabelAwareIterator,
                                LabelledDocument, LabelsSource,
                                SentenceIterator, SimpleLabelAwareIterator)
from .vocab import (VocabCache, VocabConstructor, VocabWord,
                    build_huffman_tree)
from .lookup_table import InMemoryLookupTable
from .word2vec import SequenceVectors, Word2Vec
from .paragraph_vectors import ParagraphVectors
from .glove import Glove
from .vectorizer import BagOfWordsVectorizer, TfidfVectorizer
from .iterators import (CnnSentenceDataSetIterator,
                        CollectionLabeledSentenceProvider,
                        LabeledSentenceProvider)
from .jax_tables import (load_jax_glove_tables, load_jax_graph_tables,
                         load_jax_tables)
from .lang import (CAS, AnalysisEngine, Annotator, JapaneseTokenizerFactory,
                   KoreanTokenizerFactory, SentenceAnnotator,
                   TokenAnnotator, UimaSentenceIterator,
                   UimaTokenizerFactory, japanese_tokenize, korean_tokenize)
from .lattice import (DICTIONARY, LatticeTokenizer, Trie,
                      load_connection_matrix, load_dictionary,
                      save_dictionary)

__all__ = [
    "BagOfWordsVectorizer", "BasicLineIterator",
    "CnnSentenceDataSetIterator", "CollectionLabeledSentenceProvider",
    "CollectionSentenceIterator", "CommonPreprocessor",
    "DefaultTokenizerFactory", "EndingPreProcessor", "FileSentenceIterator",
    "Glove", "InMemoryLookupTable", "LabelAwareIterator",
    "LabeledSentenceProvider", "LabelledDocument", "LabelsSource",
    "LowCasePreProcessor", "NGramTokenizerFactory", "ParagraphVectors",
    "SentenceIterator", "SequenceVectors", "SimpleLabelAwareIterator",
    "TfidfVectorizer", "Tokenizer", "TokenizerFactory", "VocabCache",
    "VocabConstructor", "VocabWord", "Word2Vec", "build_huffman_tree",
    "load_jax_glove_tables", "load_jax_graph_tables", "load_jax_tables",
    "AnalysisEngine", "Annotator", "CAS", "JapaneseTokenizerFactory",
    "KoreanTokenizerFactory", "SentenceAnnotator", "TokenAnnotator",
    "UimaSentenceIterator", "UimaTokenizerFactory", "japanese_tokenize",
    "korean_tokenize", "DICTIONARY", "LatticeTokenizer", "Trie",
    "load_connection_matrix", "load_dictionary", "save_dictionary",
]
