from dynamo_tpu_torch.preprocessor.detokenize import DecodeStream
from dynamo_tpu_torch.preprocessor.preprocessor import (
    OpenAIPreprocessor,
    PreprocessedRequest,
)
from dynamo_tpu_torch.preprocessor.stop import StopChecker
from dynamo_tpu_torch.preprocessor.tokenizer import (
    ByteTokenizer,
    GgufTokenizer,
    HfTokenizer,
    Tokenizer,
    load_tokenizer,
)

__all__ = [
    "ByteTokenizer",
    "DecodeStream",
    "GgufTokenizer",
    "HfTokenizer",
    "OpenAIPreprocessor",
    "PreprocessedRequest",
    "StopChecker",
    "Tokenizer",
    "load_tokenizer",
]
