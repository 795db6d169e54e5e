"""The port's examples (``repro_torch.examples``) held against the JAX
package's (``examples/quickstart.py``, ``examples/train_dlrm_criteo.py``):
the quickstart prints the partition counts, parameter counts and
compression ratio the reference's functions give and passes its
uniqueness check; the training example counts the reference's parameters,
trains with the partitioned optimizer and clipping, checkpoints, and a
second run resumes from the first one's last step.  On the CPU.
"""

import math
import re

from repro.core import FullEmbedding as JFull
from repro.core import qr_embedding as jqr_embedding
from repro.core import qr_partitions as jqr_partitions
from repro.core import EmbeddingSpec as JSpec
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro.models.dlrm import dlrm_num_params as jdlrm_num_params
from repro_torch.examples import quickstart, train_dlrm_criteo


def test_quickstart_prints_the_reference_counts(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    parts = jqr_partitions(10_000, m=2500)
    full, emb = JFull(10_000, 16), jqr_embedding(10_000, 16, num_collisions=4, op="mult")
    assert out[0] == (f"partitions: {parts[0].num_buckets} remainder buckets, "
                      f"{parts[1].num_buckets} quotient buckets")
    assert out[1] == (f"params: full={full.num_params:,} qr={emb.num_params:,} "
                      f"({full.num_params / emb.num_params:.1f}x smaller)")
    assert out[2] == "uniqueness: all 10000 categories map to distinct vectors"
    loss, acc = map(float, re.match(r"DLRM-with-QR forward: loss=(\S+) acc=(\S+)",
                                    out[3]).groups())
    assert math.isfinite(loss) and 0 <= acc <= 1
    assert out[4] == "quickstart OK"


def test_train_example_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "32", "--collisions", "60",
            "--ckpt-dir", str(tmp_path)]
    train_dlrm_criteo.main(argv + ["--steps", "3"])
    first = capsys.readouterr().out.splitlines()
    sizes = train_dlrm_criteo.TABLE_SIZES
    n = jdlrm_num_params(JDLRMConfig(table_sizes=sizes, embedding=JSpec(
        kind="qr", num_collisions=60, op="mult", threshold=200)))
    n_full = jdlrm_num_params(JDLRMConfig(table_sizes=sizes))
    assert first[0] == f"embedding=qr: {n:,} parameters (full would be {n_full:,})"
    assert not any(line.startswith("resumed") for line in first)
    assert [line.split()[1] for line in first if line.startswith("step")] == ["0", "2"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003"]

    train_dlrm_criteo.main(argv + ["--steps", "5"])
    second = capsys.readouterr().out.splitlines()
    assert second[1] == "resumed from step 3"
    assert [line.split()[1] for line in second if line.startswith("step")] == ["4"]
    held = [float(line.split()[-1]) for line in second if line.startswith("held-out loss:")]
    assert len(held) == 1 and math.isfinite(held[0])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000005"]
