from structure_knowledge_distillation_tpu_torch.data.cache import cached_decode, warm_cache
from structure_knowledge_distillation_tpu_torch.data.camvid import CAMVID_MEAN, CamVidDataset
from structure_knowledge_distillation_tpu_torch.data.cityscapes import (
    IMG_MEAN_BGR,
    CityscapesDataset,
    CityscapesTestDataset,
    EvalShard,
    batch_iterator,
    id2trainid,
    trainid2id,
)
from structure_knowledge_distillation_tpu_torch.data.lists import (
    ensure_list,
    make_camvid_lists,
    make_cityscapes_lists,
    make_voc_lists,
)
from structure_knowledge_distillation_tpu_torch.data.prefetch import (
    Chunk,
    cast_batches,
    chunk_batches,
    device_prefetch,
    quantize_u8,
    to_nchw,
)
from structure_knowledge_distillation_tpu_torch.data.synthetic import SyntheticSegDataset
from structure_knowledge_distillation_tpu_torch.data.voc import VOC_MEAN, VOCDataset, VOCTestDataset

# (eval resolution, default class count) per dataset, as in the JAX package:
# the reference evaluates cityscapes at (1024,2048) and VOC at (505,505);
# CamVid (360,480)/11 is the ESPNet transfer config.
DATASET_EVAL_DEFAULTS = {
    "cityscapes": ((1024, 2048), 19),
    "cityscape": ((1024, 2048), 19),
    "voc": ((505, 505), 21),
    "camvid": ((360, 480), 11),
}

# the labelled dataset class of each data set name (train and val splits)
DATASETS = {
    "cityscapes": CityscapesDataset,
    "cityscape": CityscapesDataset,
    "voc": VOCDataset,
    "camvid": CamVidDataset,
}

__all__ = [
    "CAMVID_MEAN",
    "DATASETS",
    "DATASET_EVAL_DEFAULTS",
    "IMG_MEAN_BGR",
    "CamVidDataset",
    "Chunk",
    "CityscapesDataset",
    "CityscapesTestDataset",
    "EvalShard",
    "batch_iterator",
    "cached_decode",
    "cast_batches",
    "chunk_batches",
    "device_prefetch",
    "ensure_list",
    "id2trainid",
    "make_camvid_lists",
    "make_cityscapes_lists",
    "make_voc_lists",
    "quantize_u8",
    "to_nchw",
    "trainid2id",
    "warm_cache",
    "SyntheticSegDataset",
    "VOC_MEAN",
    "VOCDataset",
    "VOCTestDataset",
]
