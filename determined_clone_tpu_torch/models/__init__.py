"""Model families of the port, each the counterpart of the module of the
same name under ``determined_clone_tpu/models``."""
from determined_clone_tpu_torch.models import (  # noqa: F401
    bert,
    gpt,
    mlp,
    mnist_cnn,
    resnet,
    vit,
)

__all__ = ["bert", "gpt", "mlp", "mnist_cnn", "resnet", "vit"]
