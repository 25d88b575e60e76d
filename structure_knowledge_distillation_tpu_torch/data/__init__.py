from structure_knowledge_distillation_tpu_torch.data.cache import cached_decode, warm_cache
from structure_knowledge_distillation_tpu_torch.data.cityscapes import (
    IMG_MEAN_BGR,
    CityscapesDataset,
    CityscapesTestDataset,
    batch_iterator,
    id2trainid,
    trainid2id,
)
from structure_knowledge_distillation_tpu_torch.data.lists import ensure_list, make_cityscapes_lists
from structure_knowledge_distillation_tpu_torch.data.prefetch import (
    Chunk,
    cast_batches,
    chunk_batches,
    device_prefetch,
    quantize_u8,
    to_nchw,
)
from structure_knowledge_distillation_tpu_torch.data.synthetic import SyntheticSegDataset

# (eval resolution, default class count) per dataset, as in the JAX package:
# the reference evaluates cityscapes at (1024,2048) and VOC at (505,505);
# CamVid (360,480)/11 is the ESPNet transfer config. Only cityscapes has a
# dataset in the port so far.
DATASET_EVAL_DEFAULTS = {
    "cityscapes": ((1024, 2048), 19),
    "cityscape": ((1024, 2048), 19),
    "voc": ((505, 505), 21),
    "camvid": ((360, 480), 11),
}

__all__ = [
    "DATASET_EVAL_DEFAULTS",
    "IMG_MEAN_BGR",
    "Chunk",
    "CityscapesDataset",
    "CityscapesTestDataset",
    "batch_iterator",
    "cached_decode",
    "cast_batches",
    "chunk_batches",
    "device_prefetch",
    "ensure_list",
    "id2trainid",
    "make_cityscapes_lists",
    "quantize_u8",
    "to_nchw",
    "trainid2id",
    "warm_cache",
    "SyntheticSegDataset",
]
