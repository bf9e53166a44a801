"""The port's training records held to the reference's.

Each ``Data<game>_torch/`` directory holds a run of ``python -m
alphatpu_torch.cli`` (``stats.jsonl``, ``latest.json``) and its probe
record (``probe.json``); the reference's ``Data<game>/`` beside it holds
the same files of its own run.  A port record must use the reference's
probe protocol, count its generations without a gap, show no illegal
move and no unfinished game on any line, and tally every probe run's
games.  Its headline score is held to the bound the reference's own
score gives (``comparable_from``), or the record names the open fault in
``ROADMAP.md`` that explains the gap.  Also the record script's own
checks, at a tiny size on the CPU.
"""
import argparse
import json
import math
import os
import re

import pytest

from alphatpu_torch.benchmarks import train_record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference probe CLI's --temp-moves default, in both packages
PROBE_TEMP_MOVES = 8
WILSON_Z = 1.96  # a 95% interval

RECORDS = [("Datatictactoe_torch", "Datatictactoe"),
           ("Dataconnect4_torch", "Dataconnect4"),
           ("Datahex7_torch", "Datahex7"),
           ("Datatictactoe_l2_torch", "Datatictactoe_l2"),
           ("Datagobang9_torch", "Datagobang9"),
           ("Datagobang8_torch", "Datagobang8"),
           ("Datareversi6x6_torch", "Datareversi6x6"),
           ("Datareversi8x8_torch", "Datareversi8x8"),
           ("Datagobang13_torch", "Datagobang13")]
# a gate: the first GATE_GENERATIONS generations at full width, no probe
GATES = [("Datareversi8x8_torch", "Datareversi8x8"),
         ("Datagobang13_torch", "Datagobang13"),
         ("Datareversi6x6_torch", "Datareversi6x6"),
         ("Datahex7_torch", "Datahex7")]


def load(directory, name):
    path = os.path.join(ROOT, directory, name)
    with open(path) as f:
        if name.endswith(".jsonl"):
            return [json.loads(x) for x in f if x.strip()]
        return json.load(f)


def temp_moves(record) -> int:
    """The sampled plies of a probe record: its field, else its command's
    flag, else the probe CLI's default."""
    if "temp_moves" in record:
        return record["temp_moves"]
    m = re.search(r"--temp-moves (\d+)", record.get("command", ""))
    return int(m.group(1)) if m else PROBE_TEMP_MOVES


def reference_level(ref) -> int:
    """The engine level of the reference's run: its probe command's
    ``ALPHATPU_PACK``, else the default 1."""
    m = re.search(r"ALPHATPU_PACK=(\d)", ref.get("command", ""))
    return int(m.group(1)) if m else 1


def score(run) -> float:
    """A probe run's score: a win counts 1, a draw one half."""
    return run["net_wins"] + run["draws"] / 2


def comparable_from(reference_score, games) -> float:
    """The least score comparable with the reference's: the Wilson 95%
    lower bound of its score over ``games`` games, rounded up to a half
    point (62.5 of 64 gives 58, 64 of 64 gives 60.5)."""
    p, z2 = reference_score / games, WILSON_Z ** 2
    low = (p + z2 / (2 * games) - WILSON_Z * math.sqrt(
        p * (1 - p) / games + z2 / (4 * games ** 2))) / (1 + z2 / games)
    return math.ceil(2 * games * low) / 2


def check_stats(lines, what):
    gens = [x["generation"] for x in lines]
    assert gens == list(range(1, len(gens) + 1)), f"{what}: generations"
    for x in lines:
        assert x["illegal_moves"] == 0, f"{what}: {x['generation']}"
        assert x["unfinished"] == 0, f"{what}: {x['generation']}"


def check_runs(runs, games, last, what):
    for run in runs:
        tally = run["net_wins"] + run["draws"] + run["net_losses"]
        assert tally == run.get("games", games), f"{what}: {run}"
        assert 1 <= run["generation"] <= last, f"{what}: {run}"


@pytest.mark.parametrize("port_dir,ref_dir", RECORDS,
                         ids=[r[0] for r in RECORDS])
def test_port_record_matches_the_reference_protocol(port_dir, ref_dir):
    port, ref = load(port_dir, "probe.json"), load(ref_dir, "probe.json")
    assert port["game"] == ref["game"]
    for key in ("probe", "probe_depth", "games", "rollouts"):
        assert port[key] == ref[key], key
    assert temp_moves(port) == temp_moves(ref)
    assert port["card"]

    lines = load(port_dir, "stats.jsonl")
    check_stats(lines, port_dir)
    last = lines[-1]["generation"]
    assert load(port_dir, "latest.json")["generation"] == last
    # the headline result is the probe run at the probed generation
    # under the record's protocol, and every run tallies its games
    keys = ("generation", "net_wins", "draws", "net_losses")
    headline = {k: port[k] for k in keys}
    same = [{k: r[k] for k in keys} for r in port["runs"]
            if r["generation"] == port["generation"]
            and temp_moves(r) == temp_moves(port)]
    assert same == [headline], port_dir
    check_runs([headline] + port["runs"], port["games"], last, port_dir)

    # the headline score against the bound the reference's score gives
    assert port["score"] == score(port)
    assert port["reference_score"] == score(ref)
    assert port["comparable_from"] == comparable_from(score(ref),
                                                      port["games"])
    if port["score"] < port["comparable_from"]:
        with open(os.path.join(ROOT, "ROADMAP.md")) as f:
            roadmap = f.read()
        assert port.get("fault") and port["fault"] in roadmap, (
            f"{port_dir}: {port['score']} under {port['comparable_from']} "
            "names no open fault of ROADMAP.md")

    # the reference's own probe on the port's net: its output line
    cross = port.get("cpu_cross_check")
    if cross is not None:
        check_runs([cross], port["games"], last, port_dir)
        raw = json.loads(cross["raw"])
        assert raw["game"] == port["game"]
        assert raw["probe_depth"] == port["probe_depth"]
        assert {k: raw[k] for k in keys[1:]} == {k: cross[k]
                                                 for k in keys[1:]}
    earlier = port.get("earlier_run")
    if earlier is not None:
        old = load(port_dir, earlier["stats"])
        check_stats(old, f"{port_dir}/{earlier['stats']}")
        check_runs(earlier["runs"], port["games"], old[-1]["generation"],
                   f"{port_dir} earlier run")
    # runs of the same command from other seeds, beside the record: each
    # held as the record's own lines and runs are, and to the reference's
    # first generations as the gate is
    ref_lines = {x["generation"]: x for x in load(ref_dir, "stats.jsonl")}
    for other in port.get("seed_runs", []):
        what = f"{port_dir}/{other['stats']}"
        seed_lines = load(port_dir, other["stats"])
        check_stats(seed_lines, what)
        assert f"--seed {other['seed']}" in other["training_command"], what
        for line in seed_lines[:train_record.GATE_GENERATIONS]:
            assert train_record.line_fault(line, ref_lines) is None, what
        check_runs(other["runs"], port["games"],
                   seed_lines[-1]["generation"], what)
        cross = other.get("cpu_cross_check")
        if cross is not None:
            raw = json.loads(cross["raw"])
            assert {k: raw[k] for k in keys[1:]} == {k: cross[k]
                                                     for k in keys[1:]}


def test_gobang13_paired_probe_is_its_traces():
    """gobang13's ``paired`` block: net 56 of each seed played the same
    256 games (the record's protocol, one set of numpy-drawn uniforms) on
    the card captured, the card eager and the port's CPU path.  Every
    figure of the block is ``probe_pair.compare`` of the committed traces;
    captured equals eager on every ply; every first divergence between the
    card and the CPU was searched again and classified, and the classes
    are those of the committed ``classify`` output."""
    from alphatpu_torch.benchmarks import probe_pair

    port = load("Datagobang13_torch", "probe.json")
    paired = port["paired"]
    assert paired["card"] and paired["seed"] == 0
    for net in paired["nets"]:
        runs = {k: load("Datagobang13_torch", v)
                for k, v in net["traces"].items()}
        assert set(runs) == {"card_captured", "card_eager", "cpu"}
        for name, run in runs.items():
            assert run["kind"] == "probe" and run["game"] == port["game"]
            assert (run["games"], run["seed"]) == (paired["games"],
                                                   paired["seed"]), name
            assert (run["rollouts"], run["probe_depth"], run["temp_moves"]) \
                == (port["rollouts"], port["probe_depth"],
                    temp_moves(port)), name
            assert probe_pair.wdl(run) == net["wdl"][name], name
            assert sum(net["wdl"][name]) == paired["games"]
            assert run["device"] == ("cpu" if name == "cpu" else "cuda")
        assert runs["card_captured"]["captured"]
        assert not runs["card_eager"]["captured"]
        same = probe_pair.compare(runs["card_captured"], runs["card_eager"])
        assert same["identical"] == paired["games"]
        assert net["captured_equals_eager"]
        cmp = probe_pair.compare(runs["card_captured"], runs["cpu"])
        for key in ("identical", "same_actions", "parting",
                    "outcome_changed", "score_difference", "spread"):
            assert net[key] == cmp[key], key
        assert net["first_divergence_histogram"] == {
            str(k): v for k, v in cmp["first_ply_histogram"].items()}
        classes = load("Datagobang13_torch", net["classes"])
        divergences = {(g, t) for t, games in
                       probe_pair.divergent_plies(cmp).items()
                       for g in games}
        assert {(x["game"], x["ply"]) for x in classes["lanes"]} == \
            divergences
        assert net["attribution"] == classes["classes"]
        assert sum(net["attribution"].values()) == len(divergences)
        rerun = load("Datagobang13_torch", net["rerun"])
        assert {t: g for t, g in probe_pair.divergent_plies(cmp).items()} \
            == {p["ply"]: p["games"] for p in rerun["plies"]}
        assert all(all(p["reproduced"]) for p in rerun["plies"])
        assert net["kernel_vs_plain_lanes"] == sum(
            p["kernel_vs_plain_lanes"] for p in rerun["plies"])
    # one selfplay generation of net 56 on the card and on the CPU path
    sp = paired["selfplay"]
    card, cpu = (load("Datagobang13_torch", sp["traces"][k])
                 for k in ("card", "cpu"))
    assert (card["device"], cpu["device"]) == ("cuda", "cpu")
    assert (card["games"], card["rounds"]) == (cpu["games"], cpu["rounds"])
    cmp = probe_pair.compare(card, cpu)
    assert sp["mean_length"] == cmp["mean_length"]
    assert sp["games_finished"] == cmp["games_finished"]
    assert sp["first_round_parting"] == cmp["first_round_parting"]
    assert sp["lanes_parted_last_round"] == cmp["lanes_parted_by_round"][-1]
    assert sp["illegal_moves"] == [0, 0]


@pytest.mark.parametrize("port_dir,ref_dir", RECORDS,
                         ids=[r[0] for r in RECORDS])
def test_port_record_trained_at_the_reference_level(port_dir, ref_dir):
    # the engine the port trained and probed with is the reference's
    port, ref = load(port_dir, "probe.json"), load(ref_dir, "probe.json")
    assert port["training"]["engine"]["level"] == reference_level(ref)


@pytest.mark.parametrize("port_dir,ref_dir", GATES,
                         ids=[g[0] for g in GATES])
def test_port_gate_matches_the_reference(port_dir, ref_dir):
    gate = load(port_dir, "gate.json")
    # a gate kept beside a full record names its own stats file
    lines = load(port_dir, gate.get("stats", "stats.jsonl"))
    ref = {x["generation"]: x for x in load(ref_dir, "stats.jsonl")}
    assert gate["game"] == load(ref_dir, "probe.json")["game"]
    assert gate["card"] and gate["training"]["engine"]["level"] == 1
    check_stats(lines, port_dir)
    assert len(lines) == len(gate["generations"]) == \
        train_record.GATE_GENERATIONS
    stages = ("selfplay_s", "train_s", "duel_s")
    for line, g in zip(lines, gate["generations"]):
        n = line["generation"]
        assert g["generation"] == n
        assert g["samples_written"] == line["samples_written"]
        want = ref[n]["samples_written"]
        assert g["reference_samples_written"] == want
        assert abs(line["samples_written"] / want - 1) <= \
            train_record.GATE_TOLERANCE, (n, line["samples_written"], want)
        assert train_record.line_fault(line, {n: ref[n]}) is None
        # the seconds by stage: the stats line's, and the wall around them
        assert {k: g[k] for k in stages} == {k: line[k] for k in stages}
        assert g["seconds"] >= sum(line[k] for k in stages)
    assert gate["training"]["seconds_per_generation"] == [
        g["seconds"] for g in gate["generations"]]


def test_hex13_gate_plays_clean_generations():
    """hex13 has no reference record: its gate is the CLI's first two
    generations at 2048 lanes (gobang13's), every game finished and no
    illegal move, with each stage's seconds and the 60-generation
    projection that ``gate_record`` derives from them."""
    from alphatpu_torch.benchmarks import gate_record

    gate = load("Datahex13_torch", "gate.json")
    lines = load("Datahex13_torch", gate["stats"])
    assert gate["game"] == "hex13" and gate["card"]
    assert gate["training"]["engine"]["level"] == 1
    assert gate["training"]["rc"] == 0 and gate["faults"] == []
    assert "--samples 2048" in gate["training"]["command"]
    check_stats(lines, "Datahex13_torch")
    assert len(lines) == train_record.GATE_GENERATIONS
    assert gate["generations"] == gate_record.generations(
        gate, lines, None)
    seconds = gate["training"]["seconds_per_generation"]
    assert gate["projection"] == gate_record.projection(seconds, 60)


def test_hex7_gate_equals_the_parent_trees():
    """hex7's gate on the flood kernel played what the torch-op flood
    played: the same samples and losses, generation for generation."""
    gate = load("Datahex7_torch", "gate.json")
    lines = load("Datahex7_torch", gate["stats"])
    assert gate["compared"]["equal"]
    assert gate["compared"]["samples_written"] == [
        x["samples_written"] for x in lines]
    assert gate["compared"]["loss"] == [x["loss"] for x in lines]


@pytest.mark.parametrize("line,fault", [
    ({"generation": 1, "illegal_moves": 0, "unfinished": 0,
      "samples_written": 650_000}, None),
    ({"generation": 2, "illegal_moves": 0, "unfinished": 0,
      "samples_written": 700_000}, "samples_written"),
    ({"generation": 1, "illegal_moves": 1, "unfinished": 0,
      "samples_written": 650_000}, "illegal_moves 1"),
    ({"generation": 3, "illegal_moves": 0, "unfinished": 2,
      "samples_written": 1}, "unfinished 2"),
])
def test_record_run_stops_on_a_faulty_line(line, fault):
    reference = {1: {"samples_written": 633_017},
                 2: {"samples_written": 833_738}}
    got = train_record.line_fault(line, reference)
    assert (got is None) if fault is None else (fault in got)


def test_record_run_trains_and_probes_on_the_cpu(tmp_path, monkeypatch):
    # the CLI and the probes are processes of their own: one thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out, ck = tmp_path / "out", tmp_path / "ck"
    monkeypatch.setattr(train_record, "PROBE_GAMES", 4)
    monkeypatch.setattr(train_record, "PROBE_ROLLOUT", 8)
    # flags after -- override the quick-start ones
    rc = train_record.main([
        "--game", "tictactoe", "--generations", "2", "--ckpt-dir", str(ck),
        "--out", str(out), "--probe-at", "1", "2", "--device", "cpu", "--",
        "--samples", "32", "--rollout", "8", "--batchsize", "32",
        "--duel-games", "16", "--duel-rollouts", "8",
        "--buffer-capacity", "4096"])
    assert rc == 0
    with open(out / "record_run.json") as f:
        record = json.load(f)
    assert record["ok"] and record["training"]["rc"] == 0
    assert len(record["training"]["seconds_per_generation"]) == 2
    assert [r["generation"] for r in record["probes"]] == [1, 2]
    for r in record["probes"]:
        assert r["net_wins"] + r["draws"] + r["net_losses"] == 4
    # the probed generations' nets are kept, the last among them
    assert sorted(os.listdir(out)) == ["latest.json", "net1.npz", "net2.npz",
                                       "record_run.json", "stats.jsonl",
                                       "train.log"]
    with open(out / "stats.jsonl") as f:
        check_stats([json.loads(x) for x in f], "tiny run")


def test_record_run_writes_the_probe_protocol_and_engine(tmp_path,
                                                         monkeypatch):
    # --temp-moves reaches every probe's command; the engine the
    # environment picks (level 2 here) is written beside it
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("ALPHATPU_PACK", "2")
    monkeypatch.delenv("ALPHATPU_NO_PACK", raising=False)
    monkeypatch.delenv("ALPHATPU_BF16_STATS", raising=False)
    monkeypatch.setattr(train_record, "PROBE_GAMES", 4)
    monkeypatch.setattr(train_record, "PROBE_ROLLOUT", 8)
    out, ck = tmp_path / "out", tmp_path / "ck"
    rc = train_record.main([
        "--game", "tictactoe", "--generations", "1", "--ckpt-dir", str(ck),
        "--out", str(out), "--probe-at", "1", "--temp-moves", "2",
        "--device", "cpu", "--", "--samples", "16", "--rollout", "8",
        "--batchsize", "16", "--duel-games", "8", "--duel-rollouts", "8",
        "--buffer-capacity", "1024"])
    assert rc == 0
    with open(out / "record_run.json") as f:
        record = json.load(f)
    assert record["temp_moves"] == 2
    assert record["training"]["engine"] == {
        "ALPHATPU_PACK": "2", "ALPHATPU_NO_PACK": None,
        "ALPHATPU_BF16_STATS": None, "level": 2}
    for r in record["probes"]:
        assert r["temp_moves"] == 2 and temp_moves(r) == 2
        assert "--temp-moves 2 " in r["command"]
        assert r["net_wins"] + r["draws"] + r["net_losses"] == 4


@pytest.mark.parametrize("reference,games", [
    ("Datagobang13/stats.jsonl", 32), ("Dataconnect4/stats.jsonl", 64),
    (None, train_record.PROBE_GAMES)])
def test_record_run_takes_the_reference_probe_games(reference, games,
                                                    monkeypatch):
    # the probe's games are the reference's probe.json's, beside the
    # stats.jsonl given as --reference, and land in every probe command
    monkeypatch.chdir(ROOT)
    assert train_record.probe_games(reference) == games
    if reference is not None:
        assert games == load(os.path.dirname(reference),
                             "probe.json")["games"]
    args = argparse.Namespace(
        game="gobang13", ckpt_dir="ck", probe_games=games, temp_moves=8,
        device="cpu")
    cmd = train_record.probe_command(args, 56)
    assert cmd[cmd.index("--games") + 1] == str(games)
    assert cmd[cmd.index("--rollout") + 1] == str(train_record.PROBE_ROLLOUT)


def test_record_run_probes_an_earlier_calls_nets(tmp_path, monkeypatch):
    # a --train-only call keeps the probed generations' nets and probes
    # none; a --probe-only call on its --out probes them and writes the
    # earlier training block beside probes of the one-call shape
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(train_record, "PROBE_GAMES", 4)
    monkeypatch.setattr(train_record, "PROBE_ROLLOUT", 8)
    first, second = tmp_path / "first", tmp_path / "second"
    rc = train_record.main([
        "--game", "tictactoe", "--generations", "2",
        "--ckpt-dir", str(tmp_path / "ck"), "--out", str(first),
        "--probe-at", "1", "2", "--train-only", "--device", "cpu", "--",
        "--samples", "16", "--rollout", "8", "--batchsize", "16",
        "--duel-games", "8", "--duel-rollouts", "8",
        "--buffer-capacity", "1024"])
    assert rc == 0
    with open(first / "record_run.json") as f:
        trained = json.load(f)
    assert trained["ok"] and "probes" not in trained
    assert trained["probe_games"] == 4
    assert {"net1.npz", "net2.npz", "latest.json"} <= set(os.listdir(first))

    rc = train_record.main([
        "--game", "tictactoe", "--ckpt-dir", str(first), "--out",
        str(second), "--probe-at", "1", "2", "--probe-only",
        "--device", "cpu"])
    assert rc == 0
    with open(second / "record_run.json") as f:
        record = json.load(f)
    assert record["ok"] and record["training"] == trained["training"]
    assert record["probe_games"] == 4
    assert [r["generation"] for r in record["probes"]] == [1, 2]
    for r in record["probes"]:
        assert set(r) == {"generation", "temp_moves", "rc", "seconds",
                          "command", "net_wins", "draws", "net_losses"}
        assert r["rc"] == 0
        assert r["net_wins"] + r["draws"] + r["net_losses"] == 4
        assert os.path.join(str(first), f"net{r['generation']}.npz") in \
            r["command"]
    # nothing trained and no net copied in the probe-only call
    assert sorted(os.listdir(second)) == ["record_run.json"]
    # a probe-only call refuses an earlier call of another game
    with pytest.raises(SystemExit):
        train_record.main([
            "--game", "connect4", "--ckpt-dir", str(first), "--out",
            str(tmp_path / "third"), "--probe-at", "1", "--probe-only",
            "--device", "cpu"])


def _fake_run(path, samples, losses, seconds, illegal=0):
    """A ``train_record`` run directory of two generations."""
    os.makedirs(path)
    lines = [{"generation": g, "samples_written": s, "carried": 7,
              "games_finished": 3, "mean_length": 9.5, "loss": l,
              "illegal_moves": illegal if g == 2 else 0, "unfinished": 0,
              "selfplay_s": 4.0, "train_s": 0.5, "duel_s": 1.5}
             for g, s, l in zip((1, 2), samples, losses)]
    with open(os.path.join(path, "stats.jsonl"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    record = {"game": "hex13", "card": "a card, 700.00 W", "torch": "2.x",
              "ok": True, "training": {
                  "command": "python -m alphatpu_torch.cli --game hex13",
                  "engine": {"level": 1}, "rc": 0, "fault": None,
                  "seconds_per_generation": seconds,
                  "seconds": sum(seconds)}}
    with open(os.path.join(path, "record_run.json"), "w") as f:
        json.dump(record, f)
    return lines


def test_gate_record_writes_the_gate_and_its_projection(tmp_path):
    """gate_record turns a two-generation run into gate.json and
    gate_stats.jsonl: each line's stages, its checkpoint seconds (the wall
    less the stages), the reference's samples beside it, the projection
    (the first generation's wall and the second's for every later one),
    and a run on another tree beside it."""
    from alphatpu_torch.benchmarks import gate_record

    lines = _fake_run(tmp_path / "run", [100, 120], [5.0, 4.5],
                      [20.0, 10.0])
    _fake_run(tmp_path / "parent", [100, 120], [5.0, 4.5], [30.0, 18.0])
    ref = tmp_path / "ref.jsonl"
    ref.write_text("".join(json.dumps({"generation": g, "samples_written": s})
                           + "\n" for g, s in ((1, 104), (2, 118), (3, 1))))
    out = tmp_path / "out"
    rc = gate_record.main(["--run", str(tmp_path / "run"), "--out", str(out),
                           "--reference", str(ref), "--compare",
                           str(tmp_path / "parent")])
    assert rc == 0
    gate = json.loads((out / "gate.json").read_text())
    stats = [json.loads(x) for x in (out / "gate_stats.jsonl").read_text()
             .splitlines()]
    assert stats == lines
    g1, g2 = gate["generations"]
    assert (g1["reference_samples_written"], g1["gap"]) == (104, -0.03846)
    assert (g2["checkpoint_s"], g2["seconds"]) == (4.0, 10.0)
    assert gate["projection"]["seconds_60_generations"] == 20.0 + 59 * 10.0
    assert gate["projection"]["fits_one_call"]
    assert gate["compared"]["equal"]
    assert gate["compared"]["seconds_per_generation"] == [30.0, 18.0]
    assert gate["faults"] == []
    # a loss apart on the other tree, or an illegal move, fails the gate
    _fake_run(tmp_path / "apart", [100, 120], [5.0, 4.25], [30.0, 18.0])
    assert gate_record.main(["--run", str(tmp_path / "run"), "--out",
                             str(out), "--compare",
                             str(tmp_path / "apart")]) == 1
    assert not json.loads((out / "gate.json").read_text())["compared"][
        "equal"]
    _fake_run(tmp_path / "illegal", [100, 120], [5.0, 4.5], [20.0, 10.0],
              illegal=1)
    assert gate_record.main(["--run", str(tmp_path / "illegal"), "--out",
                             str(out)]) == 1
