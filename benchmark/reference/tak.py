"""Plain Tak rules, one position at a time, for the benchmark's checks.

Written from the game's rules and the policy layout of the reference
implementation (takzero/src/network/repr.rs): action index
``channel * N*N + row * N + col`` with ``row = rank - 1`` and ``col =
file``; channels 0-2 place a flat, a wall, a cap; channel ``3 + dir * (2^N
- 2) + (mask - 1)`` spreads in ``dir`` (0 up, 1 right, 2 down, 3 left)
with the drop pattern ``mask`` (bit ``N - s`` set for every suffix sum
``s`` of the drops).  The first two plies place one of the opponent's
flats.  A spread carries at most N pieces; it passes only empty squares
and flats, and ends on one of those, or on a wall when a cap moves alone
onto it (the wall is crushed).  ``reversible`` counts consecutive spreads
that crushed nothing.

Nothing here imports the program: the harness converts the program's
state arrays into :class:`Position` and compares in this form.
"""

from __future__ import annotations

from dataclasses import dataclass

RESERVES = {3: (10, 0), 4: (15, 0), 5: (21, 1), 6: (30, 1), 7: (40, 2), 8: (50, 2)}
DELTAS = ((1, 0), (0, 1), (-1, 0), (0, -1))  # (row, col): up, right, down, left
EMPTY, FLAT, WALL, CAP = 0, 1, 2, 3


@dataclass
class Position:
    n: int
    stacks: list  # per square, colours bottom to top (0 white, 1 black)
    tops: list  # per square: EMPTY, FLAT, WALL or CAP
    reserves: list  # [[stones, caps] white, [stones, caps] black]
    to_move: int = 0
    ply: int = 0
    reversible: int = 0

    def key(self) -> tuple:
        return (tuple(tuple(s) for s in self.stacks), tuple(self.tops),
                tuple(tuple(r) for r in self.reserves), self.to_move, self.ply, self.reversible)


def initial(n: int) -> Position:
    stones, caps = RESERVES[n]
    return Position(n, [[] for _ in range(n * n)], [EMPTY] * (n * n), [[stones, caps], [stones, caps]])


def encode_pattern(drops, n: int) -> int:
    mask, s = 0, 0
    for d in reversed(drops):
        s += d
        mask |= 1 << (n - s)
    return mask


def _compositions(total: int, max_parts: int):
    """Every sequence of positive ints summing to ``total`` with at most
    ``max_parts`` parts."""
    if total == 0:
        yield []
        return
    if max_parts == 0:
        return
    for first in range(1, total + 1):
        for rest in _compositions(total - first, max_parts - 1):
            yield [first] + rest


def spread_channel(n: int, d: int, drops) -> int:
    return 3 + d * (2**n - 2) + encode_pattern(drops, n) - 1


def _ray(n: int, sq: int, d: int) -> list:
    r, c = divmod(sq, n)
    dr, dc = DELTAS[d]
    out = []
    r, c = r + dr, c + dc
    while 0 <= r < n and 0 <= c < n:
        out.append(r * n + c)
        r, c = r + dr, c + dc
    return out


def legal_actions(p: Position) -> list:
    """Every legal action index of ``p``, ascending."""
    n, s = p.n, p.n * p.n
    acts = []
    swap = p.ply < 2
    stones, caps = p.reserves[p.to_move]
    for sq in range(s):
        if p.tops[sq] == EMPTY:
            if swap or stones > 0:
                acts.append(sq)
            if not swap and stones > 0:
                acts.append(s + sq)
            if not swap and caps > 0:
                acts.append(2 * s + sq)
    if not swap:
        for sq in range(s):
            stack = p.stacks[sq]
            if not stack or stack[-1] != p.to_move:
                continue
            moving = p.tops[sq]
            for d in range(4):
                ray = _ray(n, sq, d)
                for carry in range(1, min(len(stack), n) + 1):
                    for drops in _compositions(carry, len(ray)):
                        k = len(drops)
                        if any(p.tops[t] not in (EMPTY, FLAT) for t in ray[: k - 1]):
                            continue
                        last = p.tops[ray[k - 1]]
                        crush = last == WALL and moving == CAP and drops[-1] == 1
                        if last in (EMPTY, FLAT) or crush:
                            acts.append(spread_channel(n, d, drops) * s + sq)
    return sorted(acts)


def _decode(n: int, channel: int):
    """(direction, drops) of a spread channel."""
    si = channel - 3
    d, mask = divmod(si, 2**n - 2)
    mask += 1
    sums = [n - b for b in range(n) if mask >> b & 1]  # descending suffix sums
    drops = [a - b for a, b in zip(sums, sums[1:] + [0])]
    return d, drops


def step(p: Position, action: int) -> Position:
    """The position after ``action`` (assumed legal)."""
    n, s = p.n, p.n * p.n
    channel, sq = divmod(action, s)
    stacks = [list(x) for x in p.stacks]
    tops = list(p.tops)
    reserves = [list(r) for r in p.reserves]
    reversible = p.reversible
    if channel < 3:
        colour = 1 - p.to_move if p.ply < 2 else p.to_move
        stacks[sq] = [colour]
        tops[sq] = channel + 1
        reserves[colour][1 if channel == 2 else 0] -= 1
        reversible = 0
    else:
        d, drops = _decode(n, channel)
        carry = sum(drops)
        stack = stacks[sq]
        carried, stacks[sq] = stack[len(stack) - carry:], stack[: len(stack) - carry]
        moving = tops[sq]
        tops[sq] = FLAT if stacks[sq] else EMPTY
        crushed = False
        at = 0
        ray = _ray(n, sq, d)
        for i, drop in enumerate(drops):
            t = ray[i]
            stacks[t] = stacks[t] + carried[at : at + drop]
            at += drop
            if i == len(drops) - 1:
                crushed = tops[t] == WALL
                tops[t] = moving
            else:
                tops[t] = FLAT
        reversible = 0 if crushed else reversible + 1
    return Position(n, stacks, tops, reserves, 1 - p.to_move, p.ply + 1, reversible)


def flat_diff(p: Position) -> int:
    """White's flats minus black's (tops that are flats)."""
    out = 0
    for sq, top in enumerate(p.tops):
        if top == FLAT:
            out += 1 if p.stacks[sq][-1] == 0 else -1
    return out


def to_tps(p: Position) -> str:
    n = p.n
    rows = []
    for r in range(n - 1, -1, -1):
        squares = []
        for c in range(n):
            sq = r * n + c
            if not p.stacks[sq]:
                squares.append("x")
                continue
            text = "".join("2" if colour else "1" for colour in p.stacks[sq])
            squares.append(text + {WALL: "S", CAP: "C"}.get(p.tops[sq], ""))
        out, run = [], 0
        for sqr in squares + [None]:
            if sqr == "x":
                run += 1
                continue
            if run:
                out.append("x" if run == 1 else f"x{run}")
                run = 0
            if sqr is not None:
                out.append(sqr)
        rows.append(",".join(out))
    return f"{'/'.join(rows)} {p.to_move + 1} {p.ply // 2 + 1}"


def from_tps(n: int, tps: str) -> Position:
    """A position from its TPS; reserves from the pieces on the board and
    ``reversible`` 0."""
    board, to_move, move_number = tps.strip().rsplit(" ", 2)
    p = initial(n)
    p.to_move = int(to_move) - 1
    p.ply = (int(move_number) - 1) * 2 + p.to_move
    rows = board.split("/")
    if len(rows) != n:
        raise ValueError(f"TPS {tps!r}: {len(rows)} rows")
    for i, row in enumerate(rows):
        r, c = n - 1 - i, 0
        for token in row.split(","):
            if token.startswith("x"):
                c += int(token[1:] or 1)
                continue
            top = {"S": WALL, "C": CAP}.get(token[-1], FLAT)
            digits = token.rstrip("SC")
            sq = r * n + c
            p.stacks[sq] = [int(x) - 1 for x in digits]
            p.tops[sq] = top
            for colour in p.stacks[sq]:
                p.reserves[colour][0] -= 1
            if top == CAP:
                p.reserves[p.stacks[sq][-1]][0] += 1
                p.reserves[p.stacks[sq][-1]][1] -= 1
            c += 1
        if c != n:
            raise ValueError(f"TPS {tps!r}: row {row!r}")
    return p


def from_fields(n: int, height, owner, tops, reserves, to_move, ply, reversible) -> Position:
    """A position from the state arrays of one game (``height``, ``owner``
    bit h = colour at height h, ``tops`` [S]; ``reserves`` [2, 2])."""
    stacks = [[(int(owner[sq]) >> h) & 1 for h in range(int(height[sq]))] for sq in range(n * n)]
    return Position(n, stacks, [int(t) for t in tops], [[int(x) for x in r] for r in reserves],
                    int(to_move), int(ply), int(reversible))


def has_road(p: Position, colour: int) -> bool:
    """A chain of ``colour``'s flats and caps (by their tops) joining two
    opposite edges, orthogonally connected."""
    n = p.n
    own = [bool(p.stacks[sq]) and p.stacks[sq][-1] == colour and p.tops[sq] in (FLAT, CAP)
           for sq in range(n * n)]
    for start, done in ((lambda r, c: c == 0, lambda r, c: c == n - 1), (lambda r, c: r == 0, lambda r, c: r == n - 1)):
        frontier = [sq for sq in range(n * n) if own[sq] and start(*divmod(sq, n))]
        seen = set(frontier)
        while frontier:
            sq = frontier.pop()
            r, c = divmod(sq, n)
            if done(r, c):
                return True
            for dr, dc in DELTAS:
                rr, cc = r + dr, c + dc
                nxt = rr * n + cc
                if 0 <= rr < n and 0 <= cc < n and own[nxt] and nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
    return False


def game_over(p: Position, reversible_limit: int = 50) -> bool:
    """A road, a full board, a player out of pieces, or the reversible-ply
    limit."""
    return (has_road(p, 0) or has_road(p, 1) or all(t != EMPTY for t in p.tops)
            or any(sum(r) == 0 for r in p.reserves) or p.reversible >= reversible_limit)


DIR_NAMES = "+>-<"


def ptn(n: int, a: int) -> str:
    """The action's Portable Tak Notation, as a match runner writes it."""
    s = n * n
    ch, sq = divmod(a, s)
    r, c = divmod(sq, n)
    square = f"{chr(ord('a') + c)}{r + 1}"
    if ch < 3:
        return ("", "S", "C")[ch] + square
    d, drops = _decode(n, ch)
    carry = sum(drops)
    return ("" if carry == 1 else str(carry)) + square + DIR_NAMES[d] + ("".join(map(str, drops)) if len(drops) > 1 else "")


def parse_ptn(n: int, text: str) -> int:
    s = n * n
    if not any(x in text for x in DIR_NAMES):
        ch = {"S": 1, "C": 2}.get(text[0], 0)
        square = text[1:] if ch else text
        return ch * s + (int(square[1:]) - 1) * n + ord(square[0]) - ord("a")
    carry = int(text[0]) if text[0].isdigit() else 1
    body = text[1:] if text[0].isdigit() else text
    square, d = body[:2], DIR_NAMES.index(body[2])
    drops = [int(x) for x in body[3:]] or [carry]
    sq = (int(square[1:]) - 1) * n + ord(square[0]) - ord("a")
    return spread_channel(n, d, drops) * s + sq
