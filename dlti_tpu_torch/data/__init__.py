"""Tokenizers and the in-memory batch pipeline."""

from dlti_tpu_torch.data.pipeline import (  # noqa: F401
    TokenBatchDataset, make_batches, pack_sequences, packed_loss_mask,
    packed_positions, pad_to_batch, tokenize_and_truncate,
)
from dlti_tpu_torch.data.tokenizer import (  # noqa: F401
    ByteTokenizer, IdTokenizer, get_tokenizer,
)
