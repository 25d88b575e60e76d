"""The R18 PSPNet student (the KD paper's Cityscapes student): PSPNet on a
dilated ResNet of `block` and `layers` from the slot, with the DSN head, as
the teacher's `pspnet.py` builds, serves and runs it; the program's
`student_arch` "resnet18"."""

from benchmark.reference import archs

_psp = archs.network("pspnet")
spec, forward, served = _psp.spec, _psp.forward, _psp.served


def program_fields(slot):
    return {"student_arch": "resnet18"}
