"""The CNN zoo (LeNet / AlexNet / VGG16), and the transformer of every
family (``layers``, ``attention``, ``transformer``, with the MoE FFN in
``moe``, the Mamba2 SSD in ``ssm`` and the RG-LRU in ``rglru``)."""
from .cnn import (
    ALEXNET,
    CNN_ZOO,
    LENET,
    VGG16,
    CNNSpec,
    NetworkPlan,
    calibrate_cnn_policy,
    cnn_forward,
    cnn_layer_names,
    fit_cnn_activations,
    init_cnn,
    plan_cnn,
    quantize_cnn_params,
    reset_plans,
)
