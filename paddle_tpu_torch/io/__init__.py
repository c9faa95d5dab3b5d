"""paddle.io (counterpart of paddle_tpu/io): datasets, samplers
(bucketed and distributed) and the DataLoader. fleet_dataset and
native_feed are not ported yet (ROADMAP.md item 18.3)."""
from .dataloader import (DataLoader, WorkerInfo,  # noqa: F401
                         default_collate_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset,  # noqa: F401
                      Dataset, IterableDataset, Subset, TensorDataset,
                      random_split)
from .sampler import (BatchSampler, BucketBatchSampler,  # noqa: F401
                      DistributedBatchSampler, RandomSampler, Sampler,
                      SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler, bucket_collate)
