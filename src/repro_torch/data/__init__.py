from repro_torch.data.femnist import generate_femnist
from repro_torch.data.pipeline import (MiniBatcher, dirichlet_partition,
                                       load_task_datasets,
                                       synthetic_token_stream)
from repro_torch.data.shakespeare import generate_shakespeare
from repro_torch.data.synthetic import generate_synthetic, train_test_split

__all__ = ["MiniBatcher", "dirichlet_partition", "load_task_datasets",
           "synthetic_token_stream", "generate_femnist",
           "generate_shakespeare", "generate_synthetic", "train_test_split"]
