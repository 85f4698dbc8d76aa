"""NLP: embeddings + text pipeline (counterpart of deeplearning4j_tpu/nlp/;
parity: deeplearning4j-nlp-parent — the SequenceVectors framework,
Word2Vec/ParagraphVectors/GloVe, tokenization, vocab, serialization; ref
models/sequencevectors/SequenceVectors.java).

The reference trains embeddings with hogwild sparse updates on a
host-resident table (SkipGram.java:224). Here the tables live on the
device (CUDA unless the caller passes device="cpu") and train by
mini-batched gathers and summed scatter-adds (negative sampling and
hierarchical softmax both), the same update applied batch-synchronously.
Tokenization, sentence iterators, vocab and the vectorizers stay host
NumPy, as in the JAX package.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    CommonPreprocessor,
    DefaultTokenizerFactory,
    StopWords,
    StopWordsPreProcessor,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (  # noqa: F401
    BasicLineIterator,
    CollectionSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabWord  # noqa: F401
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.nlp.serializer import (  # noqa: F401
    WordVectorSerializer,
    vectors_from_arrays,
)
from deeplearning4j_tpu_torch.nlp.vectorizers import (  # noqa: F401
    BagOfWordsVectorizer,
    TfidfVectorizer,
)
