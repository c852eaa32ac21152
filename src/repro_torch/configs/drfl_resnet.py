"""The paper's own experimental backbone: ResNet-18 with 4 early exits
(Models 1-4), DR-FL section 5.1.1.  Not a transformer config — the CNN is
defined in repro.models.cnn; this entry records the FL experiment defaults."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="drfl-resnet18", family="cnn",
    num_layers=4,          # 4 stages == 4 layer-wise models
    d_model=512, num_heads=1, num_kv_heads=1, d_ff=0,
    vocab_size=10,         # num classes (CIFAR10 default)
    exit_points=(1, 2, 3, 4),
    source="DR-FL paper §5.1.1 (He et al. 2015 backbone)",
)

# Paper experimental defaults (§5)
BATCH_SIZE = 32
LOCAL_EPOCHS = 5
LEARNING_RATE = 0.05
PARTICIPATION_FRACTION = 0.10
BATTERY_JOULES = 7560.0         # 1500 mAh @ 5.04 V
VALIDATION_FRACTION = 0.04      # Table 2 optimum
REWARD_WEIGHTS = (1000.0, 0.01, 1.0)   # w1, w2, w3 (footnote 1)
