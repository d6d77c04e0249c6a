"""TEI engine server (UCI-like protocol for Tak).

Counterpart of ``takzero_tpu/drivers/tei.py`` (tei/src/{main.rs,protocol.rs}):
a stdin/stdout loop speaking TEI: handshake (``tei`` -> id/option/teiok),
``setoption``, ``isready``, ``teinewgame``, ``position [startpos|tps ...]
[moves ...]``, ``go`` with wtime/btime/winc/binc/movetime/nodes/infinite,
``stop``, ``quit``.

Search runs in chunks of ``SIM_CHUNK`` simulations on one root (PUCT with
the exact solver, beta 0): one plain ``simulate`` (it expands a fresh
root), then the wavefront serve chunk (``search/serve.py``) collecting
``SIM_CHUNK - 1`` leaves per network call.  Between chunks it prints
``info`` lines (time, nodes, nps, score cp / mate, pv); the PV is walked on
the device and one int32[3 + PV_LEN] buffer is copied to the host per
chunk.  Time budget: remaining/10 + 3*increment/4 (tei/src/main.rs:241-243).
A stdin-reader thread feeds a command queue, so ``stop``/``isready`` reach
a search in flight between chunks; other commands that arrive mid-search
are deferred in order.  Trees are reused across ``position`` commands that
extend the searched position (``descend_device``).

Usage:  python -m takzero_torch.drivers.tei [--net net6_simhash] [--model CKPT]
            [--device cuda|cpu]

``--model`` and ``setoption name Model`` read the port's checkpoint format
(``takzero_torch/utils/ckpt.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import queue
import sys
import threading
import time

import numpy as np
import torch

from ..config import NET_PRESETS
from ..device import resolve_device
from ..models.agent import make_net_evaluate, new_agent
from ..search import eval as ev
from ..search.core import make_kernels
from ..search.policy import select_best_slot, slot_action
from ..search.serve import make_serve_chunk
from ..search.tree import descend_device, init_tree
from ..tak.engine import engine
from ..tak.moves import action_to_ptn, ptn_to_action
from ..tak.tps import tps_to_state
from ..utils import ckpt
from ..utils.profile import host_item, span
from . import refuse_unported

SIM_CHUNK = 128
PV_LEN = 12
MAX_NODES = 1 << 14


def info_pack(tree) -> torch.Tensor:
    """int32[3 + PV_LEN] on the tree's device: root flag, ply, value bits,
    then the PV's actions (-1 past its end).

    Each PV step follows the reference's ``select_best_action``
    (node/mod.rs:132-163): the eval-minimal child of a solved node, else
    the most visited, else the most probable, so the PV starts with the
    move that ``select_best_slot`` plays.  Every index is a [1] tensor, so
    the walk makes no host read.
    """
    ca, cn, cv, cf, cp, cval, cpr = (
        getattr(tree, f)[0] for f in
        ("child_action", "child_node", "child_visit", "child_flag", "child_ply", "child_value", "child_prob")
    )
    node = torch.zeros((1,), dtype=torch.int64, device=ca.device)
    alive = torch.ones((1,), dtype=torch.bool, device=ca.device)
    known = tree.root_flag[:1] != ev.VALUE
    acts = []
    for _ in range(PV_LEN):
        valid = ca[node] >= 0  # [1, C]
        any_valid = valid.any(-1)
        solved_slot = ev.argmin_eval(cf[node], cp[node], cval[node], valid)
        visits = torch.where(valid, cv[node], -1)
        most_visited = visits.argmax(-1)
        by_prob = torch.where(valid, cpr[node], -1.0).argmax(-1)
        unsolved = torch.where(visits.max(-1).values <= 0, by_prob, most_visited)
        slot = torch.where(known, solved_slot, unsolved)
        acts.append(torch.where(alive & any_valid, ca[node, slot], -1))
        nxt = cn[node, slot]
        alive = alive & any_valid & (nxt >= 0)
        known = cf[node, slot] != ev.VALUE
        node = torch.where(alive, nxt.to(torch.int64), node)
    return torch.cat([tree.root_flag[:1], tree.root_ply[:1], tree.root_value[:1].view(torch.int32), *acts])


def make_run_chunk(cfg, eng, bundle, device, sim_chunk: int = SIM_CHUNK):
    """``run_chunk(tree) -> tree``: one plain simulation expands a fresh
    root, then the wavefront collects ``sim_chunk - 1`` leaves for one
    network call (the reference's `virtual` feature, mcts.rs:268-328)."""
    evaluator = make_net_evaluate(cfg, eng, device=device)
    evaluate = lambda e: evaluator(bundle, e)  # noqa: E731
    simulate, _ = make_kernels(eng, evaluate, max_depth=64)
    serve = make_serve_chunk(eng, evaluate, sim_chunk - 1, max_depth=64)

    def run_chunk(tree):
        return serve(simulate(tree, 0.0), 0.0)

    return run_chunk


class TeiEngine:
    def __init__(self, net: str, model_path: str | None, out=None, commands=None, device=None):
        self.device = resolve_device(device)
        self.net_name = net
        self.model_path = model_path
        self.out = sys.stdout if out is None else out
        self.commands = commands  # queue.Queue fed by the stdin thread
        self.pending: list[str] = []  # commands deferred during a search
        self.cfg = NET_PRESETS[net]
        self.eng = engine(self.cfg.n, half_komi=self.cfg.half_komi)
        self.bundle = None  # weights; loaded by ensure_ready
        self.position = None  # TakState with a batch of 1
        self._run = None
        self.tree = None  # reused search tree (descend across positions)
        self.tree_history = None

    def send(self, line: str) -> None:
        print(line, file=self.out, flush=True)

    # ------------------------------------------------------------------
    def ensure_ready(self):
        if self.bundle is None:
            self.bundle = new_agent(self.cfg, seed=0, device=self.device)
            if self.model_path:
                ckpt.load_checkpoint_partial(self.model_path, self.bundle)
            self._run = None  # the chunk closes over the weights
        if self._run is None:
            self._run = make_run_chunk(self.cfg, self.eng, self.bundle, self.device)
        if self.position is None:
            self.position = self.eng.initial(1, self.device)

    # ------------------------------------------------------------------
    def _step(self, state, action: int):
        return self.eng.step(state, torch.tensor([action], device=self.device))

    def cmd_position(self, parts: list[str]):
        with span("tei.position"):
            self.ensure_ready()
            i = 0
            if parts[i] == "startpos":
                state = self.eng.initial(1, self.device)
                key = ("startpos",)
                i += 1
            elif parts[i] == "tps":
                # TPS is three whitespace-separated fields.
                tps = " ".join(parts[i + 1 : i + 4])
                state = tps_to_state(self.cfg.n, tps).map(lambda x: x[None].to(self.device))
                key = ("tps", tps)
                i += 4
            else:
                raise ValueError(f"bad position: {parts}")
            moves: list[str] = []
            if i < len(parts) and parts[i] == "moves":
                moves = parts[i + 1 :]
                for mv in moves:
                    state = self._step(state, ptn_to_action(self.cfg.n, mv))
            self.position = state

            # Tree reuse: when the new position extends the searched one,
            # descend through the extra moves on the device
            # (tei/src/main.rs:174-201); only the ok flag is read.
            new_hist = key + tuple(moves)
            tree = self.tree
            if tree is not None and self.tree_history is not None:
                old = self.tree_history
                if new_hist[: len(old)] == old and len(new_hist) > len(old):
                    for mv in new_hist[len(old) :]:
                        tree, ok = descend_device(tree, ptn_to_action(self.cfg.n, mv))
                        if not host_item(ok):
                            tree = None
                            break
                elif new_hist != old:
                    tree = None
            else:
                tree = None
            self.tree = tree
            self.tree_history = new_hist

    def cmd_go(self, parts: list[str]):
        with span("tei.go"):
            self.ensure_ready()
            if host_item(self.eng.terminal_kind(self.position)[0]) != 0:
                # No legal moves: any move string would be illegal. "0000" is
                # the null-move token.
                self.send("info string position is terminal")
                self.send("bestmove 0000")
                return
            opts = {}
            it = iter(parts)
            for tok in it:
                if tok in ("wtime", "btime", "winc", "binc", "movetime", "nodes"):
                    opts[tok] = int(next(it))
                elif tok == "infinite":
                    opts["infinite"] = True

            to_move = host_item(self.position.to_move[0])
            if "movetime" in opts:
                budget_s = opts["movetime"] / 1000.0
            elif "wtime" in opts or "btime" in opts:
                t = opts.get("wtime" if to_move == 0 else "btime", 10_000)
                inc = opts.get("winc" if to_move == 0 else "binc", 0)
                budget_s = (t / 10.0 + 3.0 * inc / 4.0) / 1000.0
            else:
                budget_s = 5.0
            max_nodes = opts.get("nodes", 10**9)

            tree = self.tree
            if tree is None or tree.max_nodes != MAX_NODES:
                tree = init_tree(self.eng, self.position, MAX_NODES, 256 if self.cfg.n >= 6 else 128)
            start = time.time()
            nodes = 0
            solved = False
            infinite = bool(opts.get("infinite"))
            while True:
                if solved and infinite:
                    # Root proven: under `infinite` bestmove may only follow
                    # `stop`, so idle-poll instead of burning simulations.
                    time.sleep(0.05)
                else:
                    tree = self._run(tree)
                    # One device-to-host copy per chunk: the solve state, the
                    # root eval and the PV.
                    pack = info_pack(tree)
                    with span("sync"):
                        pk = pack.cpu().numpy()
                    nodes += SIM_CHUNK
                    self._info(pk, nodes, time.time() - start)
                    solved = int(pk[0]) != ev.VALUE
                if self._poll_commands(infinite=infinite) is not None:
                    break  # stop (quit re-queued for the main loop)
                if infinite:
                    continue
                if time.time() - start >= budget_s or nodes >= max_nodes or solved:
                    break
            action = host_item(slot_action(tree, select_best_slot(tree))[0])
            self.tree = tree  # kept for descend on the next position command
            if action < 0:  # unexpanded root (defensive; terminal gated above)
                self.send("bestmove 0000")
                return
            self.send(f"bestmove {action_to_ptn(self.cfg.n, action)}")

    def _poll_commands(self, infinite: bool = False) -> str | None:
        """Drain stdin lines that arrived mid-search (the reference's
        stdin-reader thread + AtomicBool, tei/src/main.rs:113-134).

        ``isready`` is answered at once.  ``stop`` always interrupts the
        current search; deferred commands still run afterwards.  ``quit``
        interrupts when nothing is deferred ahead of it or the search is
        ``infinite`` (which only stop/quit can end); an interrupting quit is
        re-queued so the main loop exits after bestmove.  Other piped
        sequences (``go ... go ... quit``) run every search to its budget,
        because their quit is deferred in arrival order.
        """
        if self.commands is None:
            return None
        while True:
            try:
                line = self.commands.get_nowait()
            except queue.Empty:
                return None
            line = "quit" if line is None else line.strip()  # None = EOF
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "isready":
                self.send("readyok")
            elif parts[0] == "stop":
                return "stop"
            elif parts[0] == "quit" and (infinite or not self.pending):
                self.pending.append("quit")
                return "quit"
            else:
                self.pending.append(line)

    def _info(self, pk: np.ndarray, nodes, elapsed):
        flag = int(pk[0])
        ply = int(pk[1])
        value = float(pk[2:3].view(np.float32)[0])
        if flag == ev.WIN:
            score = f"mate {math.ceil(ply / 2)}"
        elif flag == ev.LOSS:
            score = f"mate -{math.ceil(ply / 2)}"
        else:
            # Probability-space value -> centipawn-ish scale.
            score = f"cp {int(600 * value)}"
        pv = [action_to_ptn(self.cfg.n, int(a)) for a in pk[3:] if int(a) >= 0]
        nps = int(nodes / max(elapsed, 1e-6))
        self.send(f"info time {int(elapsed * 1000)} nodes {nodes} nps {nps} score {score} pv {' '.join(pv)}")

    def handle(self, line: str) -> bool:
        """Process one command; returns False on quit."""
        parts = line.strip().split()
        if not parts:
            return True
        cmd, rest = parts[0], parts[1:]
        if cmd == "tei":
            self.send("id name takzero-torch")
            self.send("id author takzero-tpu contributors")
            self.send("option name Model type string")
            self.send(f"option name HalfKomi type spin default {self.cfg.half_komi}")
            self.send("teiok")
        elif cmd == "setoption":
            # setoption name X value Y
            try:
                name = rest[rest.index("name") + 1]
                value = rest[rest.index("value") + 1]
            except (ValueError, IndexError):
                return True
            if name.lower() == "model":
                self.model_path = value
                self.bundle = None
                # Stats searched under the old weights must not seed the
                # new model's searches; the position is kept.
                self.tree = None
                self.tree_history = None
            elif name.lower() == "halfkomi":
                self.cfg = dataclasses.replace(self.cfg, half_komi=int(value))
                self.eng = engine(self.cfg.n, half_komi=self.cfg.half_komi)
                self.bundle = None  # the chunk is rebuilt on the new engine
                self.position = None
                self.tree = None
                self.tree_history = None
        elif cmd == "isready":
            self.ensure_ready()
            self.send("readyok")
        elif cmd == "teinewgame":
            self.ensure_ready()
            self.position = self.eng.initial(1, self.device)
            self.tree = None
            self.tree_history = None
        elif cmd == "position":
            try:
                self.cmd_position(rest)
            except Exception as e:  # a garbled GUI line must not kill the engine
                self.send(f"info string error: bad position command ({e})")
        elif cmd == "go":
            try:
                self.cmd_go(rest)
            except Exception as e:
                self.send(f"info string error: bad go command ({e})")
                self.send("bestmove 0000")
        elif cmd == "stop":
            pass  # no search in flight: nothing to stop
        elif cmd == "quit":
            return False
        return True


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--net", default="net6_simhash", choices=list(NET_PRESETS))
    parser.add_argument("--model", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None, help="refused: this driver runs on one device")
    args = parser.parse_args(argv)
    refuse_unported(args)
    eng = TeiEngine(args.net, args.model, device=args.device)

    # A stdin-reader thread feeds a queue, so `stop`/`isready` reach a
    # search in flight (tei/src/main.rs:113-134).
    q: queue.Queue = queue.Queue()
    eng.commands = q

    def reader():
        for line in sys.stdin:
            q.put(line)
        q.put(None)  # EOF

    threading.Thread(target=reader, daemon=True).start()
    while True:
        line = eng.pending.pop(0) if eng.pending else q.get()
        if line is None or not eng.handle(line):
            break


if __name__ == "__main__":
    main()
