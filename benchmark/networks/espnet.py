"""The ESPNet-C student (Mehta et al., ECCV'18), `p` and `q` from the slot
(2 and 8 where it names none): stride-8 logits and a stride-4 auxiliary
head; the program's `student_arch` "espnet"."""

from benchmark.reference import nets


def spec(slot, classes):
    return nets.espnet_spec(classes, slot.get("p", 2), slot.get("q", 8))


def forward(c, spec, x):
    return nets.espnet_forward(c, spec, x)


def program_fields(slot):
    return {"student_arch": "espnet"}


def served(slot, classes, device):
    from structure_knowledge_distillation_tpu_torch.models import ESPNetC

    return ESPNetC(classes, slot.get("p", 2), slot.get("q", 8), device=device)
