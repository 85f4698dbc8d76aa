from deeplearning4j_tpu_torch.zoo.util.imagenet import (  # noqa: F401
    ImageNetLabels,
    decode_predictions,
)
