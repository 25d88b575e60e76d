"""PSPNet on a dilated ResNet, the teacher's slot (Zhao et al., CVPR'17; the
KD paper's frozen R101): `block` and `layers` from the slot; the program
takes the depths as `teacher_layers`."""

from benchmark.reference import nets


def spec(slot, classes):
    return nets.psp_spec(slot["block"], slot["layers"], classes)


def forward(c, spec, x):
    return nets.psp_forward(c, spec, x)


def program_fields(slot):
    return {"teacher_layers": tuple(slot["layers"])}


def served(slot, classes, device):
    from structure_knowledge_distillation_tpu_torch.models import ResPSPNet

    return ResPSPNet(slot["block"], tuple(slot["layers"]), classes, device=device)
