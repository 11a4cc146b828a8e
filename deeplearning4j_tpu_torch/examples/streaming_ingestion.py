"""Streaming ingestion: train while the data is still arriving.

The port of ``examples/streaming_ingestion.py``.  Two producers feed
``MultiLayerNetwork.fit_iterator``:

1. ``NativeBatchIterator``: the native library's producer thread
   shuffles and gathers minibatches from a host-resident array;
2. ``StoreDataSetIterator``: minibatches paged out of an
   ``ArtifactStore`` with background prefetch and per-worker shard
   splits (the reference's S3 BucketIterator training shape).

    python -m deeplearning4j_tpu_torch.examples.streaming_ingestion \\
        [--device cuda|cpu]
"""
import tempfile
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch import examples
from deeplearning4j_tpu_torch.cloud.artifacts import LocalArtifactStore
from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataFetcher
from deeplearning4j_tpu_torch.datasets.iterator import NativeBatchIterator
from deeplearning4j_tpu_torch.datasets.store_iterator import (
    StoreDataSetIterator, write_batches_to_store)
from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def mlp(dev):
    conf = (NeuralNetConfiguration.builder()
            .n_in(4).lr(0.1).momentum(0.5).use_adagrad(False)
            .activation("tanh")
            .list(2).hidden_layer_sizes(16)
            .override(1, kind=LayerKind.OUTPUT, n_out=3,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    return MultiLayerNetwork(conf, device=dev).init()


def main(argv: Optional[List[str]] = None) -> int:
    args = examples.parser(__doc__).parse_args(argv)
    dev = examples.device(args)
    examples.reset_launches()

    f = IrisDataFetcher()
    f.fetch(150)
    data = f.next().normalize_zero_mean_unit_variance().shuffle(0)

    # 1) native producer thread over a host array
    it = NativeBatchIterator(np.asarray(data.features, np.float32),
                             np.asarray(data.labels, np.float32),
                             batch_size=30, device=dev)
    net = mlp(dev)
    net.fit_iterator(it, num_epochs=60)
    used_native = it.uses_native       # close() drops the native handle
    it.close()
    print(f"native batcher  (C++ thread: {used_native}): "
          f"accuracy {net.evaluate(data).accuracy():.3f}")

    # 2) artifact store: write once, stream from a worker's shard
    store = LocalArtifactStore(tempfile.mkdtemp(prefix="dl4j_store_"))
    write_batches_to_store(store, "iris/train", data.batch_by(15))
    shard = StoreDataSetIterator(store, "iris/train",
                                 shard_index=0, num_shards=2, depth=4,
                                 device=dev)
    net2 = mlp(dev)
    net2.fit_iterator(shard, num_epochs=80)
    shard.close()
    print(f"store iterator  ({len(shard.keys)} of 10 batch keys in "
          f"shard 0/2): accuracy {net2.evaluate(data).accuracy():.3f}")
    examples.print_launches(examples.launch_counts())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
