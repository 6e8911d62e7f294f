"""The twin of ``examples/multiarch.py``, ``launch/multiarch.py``: its
list of families is the reference's ``ASSIGNED``, and on the CPU two
steps of each of the ten families at its smoke variant (bf16,
accumulation 2, LAMB at lr 1e-3, ``moe_impl="dense"``, one batch of 8 x
64 tokens reused) give finite losses, no kernel launched (the CPU runs
the plain versions), each model's family the reference config's."""
import pytest

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_config as jget_config
from repro_torch.launch import multiarch
import torch_threads  # noqa: F401  (one PyTorch thread a worker)


def test_the_arch_list_is_the_reference():
    """``--archs all`` (the default) is the reference's ``ASSIGNED``, in
    its order; a comma list is taken as given, an unknown name refused."""
    assert multiarch.parse_args([]).archs == list(JASSIGNED)
    assert multiarch.parse_args(["--archs", "all"]).archs == list(JASSIGNED)
    assert multiarch.parse_args(
        ["--archs", "qwen2-vl-7b,rwkv6-1.6b"]).archs == ["qwen2-vl-7b",
                                                         "rwkv6-1.6b"]
    with pytest.raises(SystemExit, match="bert-large"):
        multiarch.parse_args(["--archs", "bert-large"])


@pytest.mark.parametrize("arch", JASSIGNED)
def test_each_family_trains_on_the_cpu(arch):
    """Two steps of ``arch`` through ``multiarch.run`` on the CPU: two
    finite losses, the family the reference's, no kernel launch."""
    (rec,) = multiarch.run(["--device", "cpu", "--archs", arch, "--steps",
                            "2"])
    assert rec["arch"] == arch and len(rec["losses"]) == 2
    assert all(loss == loss and abs(loss) < 1e3 for loss in rec["losses"])
    assert rec["family"] == jget_config(arch).family
    assert rec["launches"] == {}
