from nanotpu_torch.data.synthetic import (  # noqa: F401
    ideal_ce,
    markov_batch,
    markov_table,
)
from nanotpu_torch.data.tokens import (  # noqa: F401
    batches,
    open_tokens,
    sample_chunk,
    write_tokens,
)
