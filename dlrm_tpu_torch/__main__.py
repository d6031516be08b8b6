import sys

from dlrm_tpu_torch.run import main

if __name__ == "__main__":
    sys.exit(main())
