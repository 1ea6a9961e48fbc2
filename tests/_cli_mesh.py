"""The train CLI's mesh for a launch it is given, without starting ranks:
``accepted_by_the_cli`` runs ``cli/common.data_parallel`` as one rank of
``torchrun``'s ranks with the process group's set-up stubbed, and returns
the mesh it made."""

from freesound_classification_tpu_torch.cli import common
from freesound_classification_tpu_torch.parallel import mesh as mesh_lib


def accepted_by_the_cli(monkeypatch, args, rank: int,
                        world: int | None = None) -> mesh_lib.Mesh:
    """The mesh ``common.data_parallel(args)`` makes on rank ``rank`` of
    ``world`` ranks (by default ``args.mesh_devices``; ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK`` set through ``monkeypatch``), after
    checking that it asked for one process group of that rank and world
    size."""
    world = args.mesh_devices if world is None else world
    made = []
    for name, value in (("WORLD_SIZE", world), ("RANK", rank),
                        ("LOCAL_RANK", rank)):
        monkeypatch.setenv(name, str(value))
    monkeypatch.setattr(mesh_lib.dist, "init_process_group",
                        lambda *a, **k: made.append(k))
    with common.data_parallel(args) as mesh:
        pass
    assert [(m["rank"], m["world_size"]) for m in made] == [(rank, world)]
    return mesh
