"""``python -m dynamo_tpu_torch.backends.mocker``."""

from dynamo_tpu_torch.backends.mocker.main import main

main()
