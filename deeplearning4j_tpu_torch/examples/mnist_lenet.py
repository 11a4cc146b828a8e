"""LeNet on MNIST through the CLI pipeline (the README's full workflow).

The port of ``examples/mnist_lenet.py``.  Synthetic MNIST-shaped idx
data by default (2,048 training and 512 test images); set ``MNIST_DIR``
(or pass --data-dir) at a directory with the four real idx files for the
full run:

    python -m deeplearning4j_tpu_torch.examples.mnist_lenet \\
        [--data-dir ~/mnist] [--epochs 3] [--device cuda|cpu]
"""
import os
import tempfile
from typing import List, Optional

from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch import examples
from deeplearning4j_tpu_torch.datasets import mnist as mnist_io
from deeplearning4j_tpu_torch.models.lenet import lenet_conf


def main(argv: Optional[List[str]] = None) -> int:
    ap = examples.parser(__doc__)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    examples.device(args)

    work = tempfile.mkdtemp(prefix="lenet_example_")
    data_dir = args.data_dir or os.environ.get("MNIST_DIR")
    if data_dir is None:
        data_dir = os.path.join(work, "mnist")
        os.makedirs(data_dir)
        x, y = mnist_io.synthetic_mnist(n=2048, seed=0)
        mnist_io.write_idx_images(
            os.path.join(data_dir, "train-images-idx3-ubyte"), x)
        mnist_io.write_idx_labels(
            os.path.join(data_dir, "train-labels-idx1-ubyte"), y)
        xt, yt = mnist_io.synthetic_mnist(n=512, seed=1)
        mnist_io.write_idx_images(
            os.path.join(data_dir, "t10k-images-idx3-ubyte"), xt)
        mnist_io.write_idx_labels(
            os.path.join(data_dir, "t10k-labels-idx1-ubyte"), yt)
        print(f"(no real archive given: wrote synthetic idx files to "
              f"{data_dir})")
    # the CLI reads the idx files from $MNIST_DIR; set for this run only
    saved = os.environ.get("MNIST_DIR")
    os.environ["MNIST_DIR"] = data_dir
    try:
        conf = os.path.join(work, "lenet.json")
        with open(conf, "w") as f:
            f.write(lenet_conf(lr=0.05).to_json())
        model = os.path.join(work, "lenet.bin")
        examples.reset_launches()
        rc = cli.main(["train", "--input", "mnist2d", "--conf", conf,
                       "--output", model, "--epochs", str(args.epochs),
                       "--batch", "128", "--device", args.device])
        rc = rc or cli.main(["test", "--input", "mnist2d-test", "--model",
                             model, "--device", args.device])
    finally:
        if saved is None:
            os.environ.pop("MNIST_DIR", None)
        else:
            os.environ["MNIST_DIR"] = saved
    examples.print_launches(examples.launch_counts())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
