"""The model zoo: which models exist, and how an ``--encoder`` name builds one.

A family is a module of its own with a dict of its ``--encoder`` names, its
model class (a ``GraphedForward``, which declares ``OUTPUTS``, ``TRAINS``
and ``PAD_MULTIPLE``) and ``create_model(cfg)``, which builds that class on
the CPU with weights seeded from ``cfg.seed``. ``FAMILIES`` lists them: BTS
(the DenseNet, ResNet, ResNeXt and MobileNetV2 encoders with the
Dense-ASPP/LPG decoder, ``models/bts.py``), NeWCRFs (``models/newcrfs.py``)
and Depth Anything V2 (``models/depth_anything.py``). A name is looked up in
its family's dict at each call, so an entry added to the dict later counts.
"""

from bts_tpu_torch.models import bts, depth_anything, newcrfs

# (dict of --encoder names, model class, builder) of each family
FAMILIES = ((bts.ENCODERS, bts.BTSModel, bts.create_model),
            (newcrfs.VERSIONS, newcrfs.NeWCRFsModel, newcrfs.create_model),
            (depth_anything.VERSIONS, depth_anything.DepthAnythingV2Model,
             depth_anything.create_model))


def _family(name: str) -> tuple:
    for family in FAMILIES:
        if name in family[0]:
            return family
    raise ValueError(f"unknown encoder {name!r}; options: "
                     f"{[n for names, _, _ in FAMILIES for n in sorted(names)]}")


def check_encoder(name: str) -> None:
    """Raise unless ``name`` is an ``--encoder`` of a family."""
    _family(name)


def model_class(name: str) -> type:
    """The class that ``--encoder name`` builds, without building it."""
    return _family(name)[1]


def create_model(cfg):
    """The model of ``cfg.encoder``, built by its family on the CPU, its
    weights seeded from ``cfg.seed``."""
    return _family(cfg.encoder)[2](cfg)


def check_trainable(model_type: type) -> None:
    """Raise for a model class that this port serves but does not train
    (``TRAINS`` false): the one check of every train step
    (``training.state.TrainState``) and of ``cli.train``'s start."""
    if not getattr(model_type, "TRAINS", True):
        trains = [n for names, cls, _ in FAMILIES if cls.TRAINS for n in sorted(names)]
        raise ValueError(f"{model_type.__name__} is served, not trained, by this port; the "
                         f"--encoder names that train: {trains}")
