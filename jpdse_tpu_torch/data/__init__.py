"""Dataset registry and loader factory, the port of
``jpdse_tpu/data/__init__.py`` (shuffle and drop_last only in training;
under a process group the training loader feeds this rank's shard, and the
eval loaders stay unsharded, so every rank sees the same metric stream)."""

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.data.ade20k import ADE20KDataset
from jpdse_tpu_torch.data.cityscapes import CityscapesDataset
from jpdse_tpu_torch.data.clic import ClicDataset
from jpdse_tpu_torch.data.custom import CustomDataset
from jpdse_tpu_torch.data.loader import DataLoader, collate  # noqa: F401
from jpdse_tpu_torch.data.paired import PairedDataset  # noqa: F401
from jpdse_tpu_torch.parallel import distributed

DATASET_REGISTRY = {
    "cityscapes": CityscapesDataset,
    "ade20k": ADE20KDataset,
    "clic": ClicDataset,
    "custom": CustomDataset,
}


def find_dataset_using_name(name: str):
    if name not in DATASET_REGISTRY:
        raise KeyError(f"dataset '{name}' not registered; available: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name]


def create_dataloader(cfg: Config) -> DataLoader:
    dataset = find_dataset_using_name(cfg.data.dataset)(cfg)
    print(f"dataset [{type(dataset).__name__}] of size {len(dataset)} was created")
    rank, world = (distributed.rank(), distributed.world()) if cfg.is_train else (0, 1)
    return DataLoader(
        dataset,
        batch_size=cfg.data.batch_size,
        shuffle=cfg.is_train,
        drop_last=cfg.is_train,
        num_workers=cfg.data.num_workers,
        seed=cfg.optim.seed,
        rank=rank,
        world=world,
    )
