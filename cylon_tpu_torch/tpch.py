"""TPC-H subset: a data generator and the 21-query suite on the DataFrame
API (port of ``cylon_tpu/tpch.py``): Q1 Q3 Q4 Q5 Q6 Q7 Q8 Q9 Q10 Q11 Q12
Q13 Q14 Q15 Q16 Q17 Q18 Q19 Q20 Q21 Q22.

* :func:`generate_tables` — the reference's numpy dbgen-alike for the
  eight tables the suite touches (customer, orders, lineitem, supplier,
  nation, region, part, partsupp; 150K/1.5M/~6M/10K/25/5/200K/800K rows x
  SF), built without pandas: the same draws, in the same order, from the
  same six streams as the reference's ``generate_pandas``, so the tables
  are the reference's value for value.  The string columns of closed
  vocabularies go straight from their vocabulary indices to a sorted
  dictionary with int32 codes (what string ingest builds from the same
  values, absent entries left out); the per-row strings (``c_name``,
  ``s_name``, ``c_phone``) take the normal string ingest.
* ``q1``..``q22`` — the reference's queries, text unchanged, written
  against the public DataFrame API (filter -> merge -> arithmetic ->
  groupby -> sort -> head), as a user would port them.

The reference's pandas oracles (``q*_pandas``) stay there: the parity
tests hold these queries against them.  Its ``bench_tpch`` entry waits
for a benchmark entry of the port (ROADMAP.md).  This module imports numpy
only, so it runs where pandas is not installed.

Dates are datetime64[ns] columns; scalar date predicates compare against
integer nanoseconds since the epoch (:func:`_ts`).
"""

from __future__ import annotations

import numpy as np

from .core.column import Column
from .core.dtypes import LogicalType
from .core.table import Table

SEGMENTS = np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                       "MACHINERY"])
REGIONS = np.asarray(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
NATIONS = np.asarray(
    ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
     "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
     "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA",
     "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"])
#: n_nationkey -> n_regionkey per the TPC-H spec nation table
NATION_REGION = np.asarray([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0,
                            0, 1, 2, 3, 4, 2, 3, 3, 1])
PRIORITIES = np.asarray(["1-URGENT", "2-HIGH", "3-MEDIUM",
                         "4-NOT SPECIFIED", "5-LOW"])
SHIPMODES = np.asarray(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                        "TRUCK"])
SHIPINSTRUCT = np.asarray(["COLLECT COD", "DELIVER IN PERSON", "NONE",
                           "TAKE BACK RETURN"])
PTYPES = np.asarray(["PROMO ANODIZED", "PROMO BURNISHED", "PROMO PLATED",
                     "STANDARD PLATED", "ECONOMY BRUSHED",
                     "MEDIUM POLISHED"])
PROMO_TYPES = tuple(t for t in PTYPES if t.startswith("PROMO"))
BRANDS = np.asarray([f"Brand#{i}{j}" for i in range(1, 6)
                     for j in range(1, 6)])
CONTAINERS = np.asarray([f"{s} {c}" for s in ("SM", "MED", "LG", "JUMBO",
                                              "WRAP")
                         for c in ("CASE", "BOX", "BAG", "JAR", "PKG",
                                   "PACK", "CAN", "DRUM")])
#: closed p_name vocabulary (Q20's ``p_name LIKE 'forest%'`` becomes an
#: exact-value IN over the forest-prefixed entries — the engine has no
#: device-side substring, same documented simplification as Q22's phone
#: prefix)
PNAME_ADJ = ("almond", "antique", "azure", "forest", "frosted", "lavender")
PNAME_NOUN = ("beige", "blush", "cream", "linen", "misty")
PNAMES = np.asarray([f"{a} {n}" for a in PNAME_ADJ for n in PNAME_NOUN])


def _ts(date: str) -> int:
    """Nanoseconds since the epoch of an ISO date (the reference's
    ``pd.Timestamp(date).value``)."""
    return int(np.datetime64(date, "ns").astype(np.int64))


def _vocab(vocab: np.ndarray, idx: np.ndarray) -> Column:
    """A closed-vocabulary string column from vocabulary indices: the
    present entries in sorted order as the dictionary, each row's int32
    code its entry's rank there — what string ingest of ``vocab[idx]``
    gives (``np.unique``), without building the per-row strings."""
    present = np.nonzero(np.bincount(idx, minlength=len(vocab)))[0]
    order = np.argsort(vocab[present], kind="stable")
    code_of = np.zeros(len(vocab), np.int32)
    code_of[present[order]] = np.arange(len(present), dtype=np.int32)
    return Column(code_of[idx], LogicalType.STRING, None,
                  np.asarray(vocab[present[order]], dtype=object))


_col = Column.from_numpy


def generate_columns(scale: float = 0.01, seed: int = 0) -> dict:
    """The eight tables as host columns: ``{table: {name: Column}}``, in
    the reference's column order.  The draws follow the reference's
    ``generate_pandas`` one for one."""
    rng = np.random.default_rng(seed)
    n_cust = max(int(150_000 * scale), 10)
    n_ord = max(int(1_500_000 * scale), 40)
    n_supp = max(int(10_000 * scale), 5)
    lines_per_order = rng.integers(1, 8, n_ord)
    n_line = int(lines_per_order.sum())

    day = 24 * 3600 * 1_000_000_000
    d0 = _ts("1992-01-01")
    span = (_ts("1998-08-02") - d0) // day

    c_seg = rng.integers(0, len(SEGMENTS), n_cust)
    c_nationkey = rng.integers(0, 25, n_cust).astype(np.int64)
    customer = {
        "c_custkey": _col(np.arange(n_cust, dtype=np.int64)),
        "c_name": _col(np.char.add(
            "Customer#", np.arange(n_cust).astype(np.str_))),
        "c_mktsegment": _vocab(SEGMENTS, c_seg),
        "c_nationkey": _col(c_nationkey),
        "c_acctbal": _col(np.round(rng.uniform(-999.99, 9999.99, n_cust),
                                   2)),
    }
    o_orderkey = np.arange(n_ord, dtype=np.int64)
    o_custkey = rng.integers(0, n_cust, n_ord).astype(np.int64)
    o_orderdate = (d0 + rng.integers(0, span, n_ord) * day
                   ).astype("datetime64[ns]")
    o_prio = rng.integers(0, len(PRIORITIES), n_ord)
    orders = {
        "o_orderkey": _col(o_orderkey),
        "o_custkey": _col(o_custkey),
        "o_orderdate": _col(o_orderdate),
        "o_shippriority": _col(np.zeros(n_ord, dtype=np.int64)),
        "o_orderpriority": _vocab(PRIORITIES, o_prio),
    }
    l_orderkey = np.repeat(o_orderkey, lines_per_order)
    ship_delay = rng.integers(1, 122, n_line) * day
    shipdate = (np.repeat(o_orderdate, lines_per_order).astype(np.int64)
                + ship_delay).astype("datetime64[ns]")
    del ship_delay
    commitdate = (shipdate.astype(np.int64)
                  + rng.integers(-30, 61, n_line) * day
                  ).astype("datetime64[ns]")
    receiptdate = (shipdate.astype(np.int64)
                   + rng.integers(1, 31, n_line) * day
                   ).astype("datetime64[ns]")
    # returnflag/linestatus per the spec's date rules: lines shipped after
    # the cutoff are still Open/None, earlier ones Fulfilled and split A/R
    cutoff = np.datetime64("1995-06-17")
    open_line = shipdate > cutoff
    ar = rng.integers(0, 2, n_line)
    lineitem = {
        "l_orderkey": _col(l_orderkey),
        "l_suppkey": _col(rng.integers(0, n_supp, n_line).astype(np.int64)),
        "l_quantity": _col(rng.integers(1, 51, n_line).astype(np.int64)),
        "l_extendedprice": _col(np.round(
            rng.uniform(900.0, 105_000.0, n_line), 2)),
        "l_discount": _col(np.round(rng.integers(0, 11, n_line) * 0.01, 2)),
        "l_tax": _col(np.round(rng.integers(0, 9, n_line) * 0.01, 2)),
        # vocabularies ["A", "N", "R"] and ["F", "O"]
        "l_returnflag": _vocab(np.asarray(["A", "N", "R"]),
                               np.where(open_line, 1,
                                        np.where(ar == 0, 0, 2))),
        "l_linestatus": _vocab(np.asarray(["F", "O"]),
                               open_line.astype(np.int64)),
        "l_shipdate": _col(shipdate),
        "l_commitdate": _col(commitdate),
        "l_receiptdate": _col(receiptdate),
        "l_shipmode": _vocab(SHIPMODES,
                             rng.integers(0, len(SHIPMODES), n_line)),
    }
    del ar, commitdate, receiptdate
    supplier = {
        "s_suppkey": _col(np.arange(n_supp, dtype=np.int64)),
        "s_nationkey": _col(rng.integers(0, 25, n_supp).astype(np.int64)),
    }
    # part and the Q14/Q18/Q19 columns: the second stream
    rng2 = np.random.default_rng(seed + 104729)
    n_part = max(int(200_000 * scale), 8)
    part = {
        "p_partkey": _col(np.arange(n_part, dtype=np.int64)),
        "p_type": _vocab(PTYPES, rng2.integers(0, len(PTYPES), n_part)),
        "p_brand": _vocab(BRANDS, rng2.integers(0, len(BRANDS), n_part)),
        "p_container": _vocab(CONTAINERS,
                              rng2.integers(0, len(CONTAINERS), n_part)),
        "p_size": _col(rng2.integers(1, 51, n_part).astype(np.int64)),
    }
    lineitem["l_partkey"] = _col(
        rng2.integers(0, n_part, n_line).astype(np.int64))
    lineitem["l_shipinstruct"] = _vocab(
        SHIPINSTRUCT, rng2.integers(0, len(SHIPINSTRUCT), n_line))
    orders["o_totalprice"] = _col(np.round(
        rng2.uniform(1_000.0, 500_000.0, n_ord), 2))
    nation = {
        "n_nationkey": _col(np.arange(25, dtype=np.int64)),
        "n_name": _vocab(NATIONS, np.arange(25)),
        "n_regionkey": _col(NATION_REGION.astype(np.int64)),
    }
    region = {
        "r_regionkey": _col(np.arange(5, dtype=np.int64)),
        "r_name": _vocab(REGIONS, np.arange(5)),
    }
    # Q16/Q21/Q22 additions: the third stream
    rng3 = np.random.default_rng(seed + 7919)
    ps_partkey = np.repeat(np.arange(n_part, dtype=np.int64), 4)
    partsupp = {
        "ps_partkey": _col(ps_partkey),
        "ps_suppkey": _col(rng3.integers(0, n_supp, len(ps_partkey))
                           .astype(np.int64)),
        "ps_availqty": _col(rng3.integers(1, 10_000, len(ps_partkey))
                            .astype(np.int64)),
    }
    supplier["s_name"] = _col(np.char.add(
        "Supplier#", np.arange(n_supp).astype(np.str_)))
    # vocabulary ["Customer Complaints", "ok"]
    supplier["s_comment"] = _vocab(
        np.asarray(["Customer Complaints", "ok"]),
        np.where(rng3.random(n_supp) < 0.02, 0, 1))
    # orderstatus: F when every line shipped by the cutoff, O when none,
    # else P — from the open_line flags per order
    open_per_order = np.bincount(l_orderkey, weights=open_line,
                                 minlength=n_ord).astype(np.int64)
    del open_line, l_orderkey
    # vocabulary ["F", "O", "P"]
    orders["o_orderstatus"] = _vocab(
        np.asarray(["F", "O", "P"]),
        np.where(open_per_order == 0, 0,
                 np.where(open_per_order == lines_per_order, 1, 2)))
    # Q22's phone prefix rides its own int column as well
    cntry = c_nationkey + 10
    customer["c_phone"] = _col(np.char.add(
        np.char.add(cntry.astype(np.str_), "-555-"),
        np.arange(n_cust).astype(np.str_)))
    customer["c_cntrycode"] = _col(cntry.astype(np.int64))
    # Q11: the fourth stream
    rng4 = np.random.default_rng(seed + 15485863)
    partsupp["ps_supplycost"] = _col(np.round(
        rng4.uniform(1.0, 1000.0, len(ps_partkey)), 2))
    # Q20: the fifth stream
    rng5 = np.random.default_rng(seed + 32452843)
    part["p_name"] = _vocab(PNAMES, rng5.integers(0, len(PNAMES), n_part))
    # Q13: the sixth stream; vocabulary ["ok", "special requests"]
    rng6 = np.random.default_rng(seed + 86028121)
    orders["o_comment"] = _vocab(
        np.asarray(["ok", "special requests"]),
        (rng6.random(n_ord) < 0.05).astype(np.int64))
    # Q9's and Q7's extract(year) ride derived int columns (no draws)
    orders["o_orderyear"] = _col(_year(o_orderdate))
    lineitem["l_shipyear"] = _col(_year(shipdate))
    return {"customer": customer, "orders": orders, "lineitem": lineitem,
            "supplier": supplier, "nation": nation, "region": region,
            "part": part, "partsupp": partsupp}


def _year(ts: np.ndarray) -> np.ndarray:
    """The calendar year of datetime64 values, as int64."""
    return ts.astype("datetime64[Y]").astype(np.int64) + 1970


def generate_tables(scale: float = 0.01, env=None, seed: int = 0) -> dict:
    """Device-resident DataFrames of the eight tables on ``env`` (the
    default env when None)."""
    from .ctx.context import refuse_multi_process
    from .frame import DataFrame
    refuse_multi_process(env, "the TPC-H tables")
    return {name: DataFrame(_table=Table.from_host_columns(cols, env))
            for name, cols in generate_columns(scale, seed).items()}


# ---------------------------------------------------------------------------
# Q1 — pricing summary report
# ---------------------------------------------------------------------------

def q1(dfs: dict, env=None, date: str = "1998-09-02"):
    """SELECT l_returnflag, l_linestatus, sum(l_quantity), sum(price),
    sum(price*(1-disc)), sum(price*(1-disc)*(1+tax)), avg(qty), avg(price),
    avg(disc), count(*) FROM lineitem WHERE l_shipdate <= :date GROUP BY
    l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus."""
    line = dfs["lineitem"]
    l = line[line["l_shipdate"] <= _ts(date)]
    l["disc_price"] = l["l_extendedprice"] * (1.0 - l["l_discount"])
    l["charge"] = l["disc_price"] * (1.0 + l["l_tax"])
    g = (l.groupby(["l_returnflag", "l_linestatus"], env=env)
         .agg([("l_quantity", "sum"), ("l_extendedprice", "sum"),
               ("disc_price", "sum"), ("charge", "sum"),
               ("l_quantity", "mean"), ("l_extendedprice", "mean"),
               ("l_discount", "mean"), ("l_orderkey", "count")]))
    return g.sort_values(["l_returnflag", "l_linestatus"], env=env)


# ---------------------------------------------------------------------------
# Q6 — revenue-change forecast
# ---------------------------------------------------------------------------

def q6(dfs: dict, env=None, date_lo: str = "1994-01-01",
       date_hi: str = "1995-01-01", discount: float = 0.06,
       quantity: int = 24):
    """SELECT sum(l_extendedprice*l_discount) AS revenue FROM lineitem
    WHERE l_shipdate >= :lo AND l_shipdate < :hi AND l_discount BETWEEN
    :d - 0.01 AND :d + 0.01 AND l_quantity < :q (the filter widens the
    BETWEEN bounds by 0.001 — float tolerance for the 0.01-grid discount
    values, matching the oracle)."""
    l = dfs["lineitem"]
    sel = ((l["l_shipdate"] >= _ts(date_lo)) & (l["l_shipdate"] < _ts(date_hi))
           & (l["l_discount"] >= discount - 0.011)
           & (l["l_discount"] <= discount + 0.011)
           & (l["l_quantity"] < quantity))
    f = l[sel]
    rev = f["l_extendedprice"] * f["l_discount"]
    return float(rev.sum())


# ---------------------------------------------------------------------------
# Q3 — shipping priority
# ---------------------------------------------------------------------------

def q3(dfs: dict, env=None, segment: str = "BUILDING",
       date: str = "1995-03-15"):
    """SELECT l_orderkey, sum(l_extendedprice*(1-l_discount)) AS revenue,
    o_orderdate, o_shippriority FROM customer, orders, lineitem WHERE
    c_mktsegment = :segment AND c_custkey = o_custkey AND l_orderkey =
    o_orderkey AND o_orderdate < :date AND l_shipdate > :date GROUP BY
    l_orderkey, o_orderdate, o_shippriority ORDER BY revenue DESC,
    o_orderdate LIMIT 10."""
    cust = dfs["customer"]
    orders = dfs["orders"]
    line = dfs["lineitem"]
    t = _ts(date)

    c = cust[cust["c_mktsegment"] == segment]
    o = orders[orders["o_orderdate"] < t]
    l = line[line["l_shipdate"] > t]

    co = c.merge(o, left_on="c_custkey", right_on="o_custkey", env=env)
    col = co.merge(l, left_on="o_orderkey", right_on="l_orderkey", env=env)
    col["revenue"] = col["l_extendedprice"] * (1.0 - col["l_discount"])
    g = (col.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                     env=env)[["revenue"]].sum())
    out = g.sort_values(["revenue", "o_orderdate"],
                        ascending=[False, True], env=env).head(10)
    return out[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]


# ---------------------------------------------------------------------------
# Q5 — local supplier volume
# ---------------------------------------------------------------------------

def q5(dfs: dict, env=None, region: str = "ASIA",
       date_lo: str = "1994-01-01", date_hi: str = "1995-01-01"):
    """SELECT n_name, sum(l_extendedprice*(1-l_discount)) AS revenue FROM
    customer, orders, lineitem, supplier, nation, region WHERE c_custkey =
    o_custkey AND l_orderkey = o_orderkey AND l_suppkey = s_suppkey AND
    c_nationkey = s_nationkey AND s_nationkey = n_nationkey AND n_regionkey
    = r_regionkey AND r_name = :region AND o_orderdate >= :lo AND
    o_orderdate < :hi GROUP BY n_name ORDER BY revenue DESC."""
    lo, hi = _ts(date_lo), _ts(date_hi)
    reg = dfs["region"]
    reg = reg[reg["r_name"] == region]
    nat = dfs["nation"].merge(reg, left_on="n_regionkey",
                              right_on="r_regionkey", env=env)
    sup = dfs["supplier"].merge(nat, left_on="s_nationkey",
                                right_on="n_nationkey", env=env)
    o = dfs["orders"]
    o = o[(o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi)]
    co = dfs["customer"].merge(o, left_on="c_custkey", right_on="o_custkey",
                               env=env)
    col = co.merge(dfs["lineitem"], left_on="o_orderkey",
                   right_on="l_orderkey", env=env)
    # l_suppkey = s_suppkey AND c_nationkey = s_nationkey (two-column key)
    j = col.merge(sup, left_on=["l_suppkey", "c_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"], env=env)
    j["revenue"] = j["l_extendedprice"] * (1.0 - j["l_discount"])
    g = j.groupby(["n_name"], env=env)[["revenue"]].sum()
    return g.sort_values("revenue", ascending=False,
                         env=env)[["n_name", "revenue"]]


# ---------------------------------------------------------------------------
# Q4 — order priority checking (EXISTS semi-join)
# ---------------------------------------------------------------------------

def q4(dfs: dict, env=None, date_lo: str = "1993-07-01",
       date_hi: str = "1993-10-01"):
    """SELECT o_orderpriority, count(*) AS order_count FROM orders WHERE
    o_orderdate >= :lo AND o_orderdate < :hi AND EXISTS (SELECT * FROM
    lineitem WHERE l_orderkey = o_orderkey AND l_commitdate <
    l_receiptdate) GROUP BY o_orderpriority ORDER BY o_orderpriority.
    The EXISTS is a semi-join: dedupe the qualifying lineitem order keys,
    then inner-merge (reference pattern: DistributedUnique + join)."""
    o = dfs["orders"]
    o = o[(o["o_orderdate"] >= _ts(date_lo))
          & (o["o_orderdate"] < _ts(date_hi))]
    l = dfs["lineitem"]
    l = l[l["l_commitdate"] < l["l_receiptdate"]]
    lk = l[["l_orderkey"]].drop_duplicates(env=env)
    j = o.merge(lk, left_on="o_orderkey", right_on="l_orderkey", env=env)
    g = (j.groupby(["o_orderpriority"], env=env)
         .agg([("o_orderkey", "count")]))
    out = g.sort_values("o_orderpriority", env=env)
    return out.rename({"o_orderkey_count": "order_count"})


# ---------------------------------------------------------------------------
# Q10 — returned item reporting
# ---------------------------------------------------------------------------

def q10(dfs: dict, env=None, date_lo: str = "1993-10-01",
        date_hi: str = "1994-01-01", limit: int = 20):
    """SELECT c_custkey, c_name, sum(l_extendedprice*(1-l_discount)) AS
    revenue, c_acctbal, n_name FROM customer, orders, lineitem, nation
    WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey AND
    o_orderdate >= :lo AND o_orderdate < :hi AND l_returnflag = 'R' AND
    c_nationkey = n_nationkey GROUP BY c_custkey, c_name, c_acctbal,
    n_name ORDER BY revenue DESC LIMIT 20."""
    o = dfs["orders"]
    o = o[(o["o_orderdate"] >= _ts(date_lo))
          & (o["o_orderdate"] < _ts(date_hi))]
    l = dfs["lineitem"]
    l = l[l["l_returnflag"] == "R"]
    co = dfs["customer"].merge(o, left_on="c_custkey", right_on="o_custkey",
                               env=env)
    col = co.merge(l, left_on="o_orderkey", right_on="l_orderkey", env=env)
    j = col.merge(dfs["nation"], left_on="c_nationkey",
                  right_on="n_nationkey", env=env)
    j["revenue"] = j["l_extendedprice"] * (1.0 - j["l_discount"])
    g = (j.groupby(["c_custkey", "c_name", "c_acctbal", "n_name"],
                   env=env)[["revenue"]].sum())
    out = g.sort_values(["revenue", "c_custkey"], ascending=[False, True],
                        env=env).head(limit)
    return out[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name"]]


# ---------------------------------------------------------------------------
# Q12 — shipping modes and order priority
# ---------------------------------------------------------------------------

def q12(dfs: dict, env=None, mode1: str = "MAIL", mode2: str = "SHIP",
        date_lo: str = "1994-01-01", date_hi: str = "1995-01-01"):
    """SELECT l_shipmode, sum(high_line_count), sum(low_line_count) FROM
    orders, lineitem WHERE o_orderkey = l_orderkey AND l_shipmode IN
    (:m1, :m2) AND l_commitdate < l_receiptdate AND l_shipdate <
    l_commitdate AND l_receiptdate >= :lo AND l_receiptdate < :hi GROUP BY
    l_shipmode ORDER BY l_shipmode; high = priority in (1-URGENT, 2-HIGH)."""
    l = dfs["lineitem"]
    sel = (_isin(l["l_shipmode"], [mode1, mode2])
           & (l["l_commitdate"] < l["l_receiptdate"])
           & (l["l_shipdate"] < l["l_commitdate"])
           & (l["l_receiptdate"] >= _ts(date_lo))
           & (l["l_receiptdate"] < _ts(date_hi)))
    lf = l[sel]
    j = lf.merge(dfs["orders"], left_on="l_orderkey", right_on="o_orderkey",
                 env=env)
    high = ((j["o_orderpriority"] == "1-URGENT")
            | (j["o_orderpriority"] == "2-HIGH"))
    j["high_line"] = high.astype("int64")
    j["low_line"] = (~high).astype("int64")
    g = (j.groupby(["l_shipmode"], env=env)
         .agg([("high_line", "sum"), ("low_line", "sum")]))
    out = g.sort_values("l_shipmode", env=env)
    return out.rename({"high_line_sum": "high_line_count",
                       "low_line_sum": "low_line_count"})


# ---------------------------------------------------------------------------
# Q13 — customer distribution (LEFT join + two-level groupby)
# ---------------------------------------------------------------------------

def q13(dfs: dict, env=None, word: str = "special requests"):
    """SELECT c_count, count(*) AS custdist FROM (SELECT c_custkey,
    count(o_orderkey) AS c_count FROM customer LEFT OUTER JOIN orders ON
    c_custkey = o_custkey AND o_comment NOT LIKE '%special%requests%'
    GROUP BY c_custkey) GROUP BY c_count ORDER BY custdist DESC, c_count
    DESC.  The comment filter applies to the RIGHT side before the left
    join (filtering after would drop the no-order customers the query
    counts); o_comment is a closed vocabulary so NOT LIKE is an exact !=
    (documented generator simplification).  count(o_orderkey) counts
    NON-NULL keys only, so customers whose every order was filtered (or
    who never ordered) land in the c_count = 0 bucket — the left join's
    null extension is exactly what the count distribution measures.
    This is the profiler's acceptance workload: its EXPLAIN ANALYZE plan
    is recorded in the tpch bench JSON detail (docs/observability.md)."""
    o = dfs["orders"]
    o = o[o["o_comment"] != word][["o_custkey", "o_orderkey"]]
    j = dfs["customer"][["c_custkey"]].merge(
        o, how="left", left_on="c_custkey", right_on="o_custkey", env=env)
    per_cust = (j.groupby(["c_custkey"], env=env)
                .agg([("o_orderkey", "count")])
                .rename({"o_orderkey_count": "c_count"}))
    dist = (per_cust.groupby(["c_count"], env=env)
            .agg([("c_custkey", "count")])
            .rename({"c_custkey_count": "custdist"}))
    out = dist.sort_values(["custdist", "c_count"],
                           ascending=[False, False], env=env)
    return out[["c_count", "custdist"]]


# ---------------------------------------------------------------------------
# Q14 — promotion effect (join + conditional aggregate)
# ---------------------------------------------------------------------------

def q14(dfs: dict, env=None, date_lo: str = "1995-09-01",
        date_hi: str = "1995-10-01") -> float:
    """SELECT 100 * sum(case when p_type like 'PROMO%' then
    l_extendedprice*(1-l_discount) else 0 end) / sum(l_extendedprice*
    (1-l_discount)) FROM lineitem, part WHERE l_partkey = p_partkey AND
    l_shipdate >= :lo AND l_shipdate < :hi.  The LIKE prefix match is an
    isin over the generator's closed p_type vocabulary (PROMO_TYPES)."""
    l = dfs["lineitem"]
    l = l[(l["l_shipdate"] >= _ts(date_lo)) & (l["l_shipdate"] < _ts(date_hi))]
    j = l.merge(dfs["part"], left_on="l_partkey", right_on="p_partkey",
                env=env)
    rev = j["l_extendedprice"] * (1.0 - j["l_discount"])
    promo = _isin(j["p_type"], list(PROMO_TYPES))
    promo_rev = (promo.astype("float64") * rev).sum()
    total = rev.sum()
    return float(100.0 * promo_rev / total) if total else 0.0


# ---------------------------------------------------------------------------
# Q18 — large volume customer (groupby-HAVING semi-join)
# ---------------------------------------------------------------------------

def q18(dfs: dict, env=None, quantity: int = 300, limit: int = 100):
    """SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum(l_quantity) FROM customer, orders, lineitem WHERE o_orderkey IN
    (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey HAVING
    sum(l_quantity) > :q) AND c_custkey = o_custkey AND o_orderkey =
    l_orderkey GROUP BY c_name, c_custkey, o_orderkey, o_orderdate,
    o_totalprice ORDER BY o_totalprice DESC, o_orderdate LIMIT 100.
    The HAVING subquery is a groupby + filter + semi-join (reference
    pattern: DistributedHashGroupBy then DistributedJoin)."""
    l = dfs["lineitem"]
    big = l.groupby(["l_orderkey"], env=env).agg([("l_quantity", "sum")])
    big = big[big["l_quantity_sum"] > float(quantity)][["l_orderkey"]]
    o = dfs["orders"].merge(big, left_on="o_orderkey", right_on="l_orderkey",
                            env=env)
    co = dfs["customer"].merge(o, left_on="c_custkey", right_on="o_custkey",
                               env=env)
    j = co.merge(l, left_on="o_orderkey", right_on="l_orderkey", env=env)
    g = (j.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice"], env=env)
         .agg([("l_quantity", "sum")]))
    out = g.sort_values(["o_totalprice", "o_orderdate"],
                        ascending=[False, True], env=env).head(limit)
    return out[["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                "o_totalprice", "l_quantity_sum"]]


# ---------------------------------------------------------------------------
# Q19 — discounted revenue (disjunctive multi-attribute filters)
# ---------------------------------------------------------------------------

def _isin(series, values):
    out = series == values[0]
    for v in values[1:]:
        out = out | (series == v)
    return out


def q19(dfs: dict, env=None, brand1: str = "Brand#12",
        brand2: str = "Brand#23", brand3: str = "Brand#34",
        q1_: int = 1, q2_: int = 10, q3_: int = 20) -> float:
    """SELECT sum(l_extendedprice*(1-l_discount)) FROM lineitem, part WHERE
    three disjunctive (brand, container-set, quantity-range, size-range)
    branches AND l_shipmode IN (AIR, REG AIR) AND l_shipinstruct =
    'DELIVER IN PERSON' — the classic disjunctive-predicate stressor: one
    join, then one boolean tree over five columns."""
    l = dfs["lineitem"]
    l = l[_isin(l["l_shipmode"], ["AIR", "REG AIR"])
          & (l["l_shipinstruct"] == "DELIVER IN PERSON")]
    j = l.merge(dfs["part"], left_on="l_partkey", right_on="p_partkey",
                env=env)
    qty, size = j["l_quantity"], j["p_size"]
    b1 = ((j["p_brand"] == brand1)
          & _isin(j["p_container"], ["SM CASE", "SM BOX", "SM PACK",
                                     "SM PKG"])
          & (qty >= q1_) & (qty <= q1_ + 10) & (size >= 1) & (size <= 5))
    b2 = ((j["p_brand"] == brand2)
          & _isin(j["p_container"], ["MED BAG", "MED BOX", "MED PKG",
                                     "MED PACK"])
          & (qty >= q2_) & (qty <= q2_ + 10) & (size >= 1) & (size <= 10))
    b3 = ((j["p_brand"] == brand3)
          & _isin(j["p_container"], ["LG CASE", "LG BOX", "LG PACK",
                                     "LG PKG"])
          & (qty >= q3_) & (qty <= q3_ + 10) & (size >= 1) & (size <= 15))
    f = j[b1 | b2 | b3]
    rev = f["l_extendedprice"] * (1.0 - f["l_discount"])
    return float(rev.sum())


# ---------------------------------------------------------------------------
# Q16 — parts/supplier relationship (ANTI join vs complained suppliers)
# ---------------------------------------------------------------------------

def q16(dfs: dict, env=None, brand: str = "Brand#45",
        sizes=(49, 14, 23, 45, 19, 3, 36, 9)):
    """SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS
    supplier_cnt FROM partsupp, part WHERE p_partkey = ps_partkey AND
    p_brand <> :brand AND p_type NOT LIKE 'PROMO%' AND p_size IN :sizes
    AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier WHERE s_comment
    LIKE '%Customer%Complaints%') GROUP BY p_brand, p_type, p_size ORDER
    BY supplier_cnt DESC, p_brand, p_type, p_size.  The NOT IN is an ANTI
    join; NOT LIKE maps to the generator's type vocabulary."""
    p = dfs["part"]
    p = p[(p["p_brand"] != brand)
          & ~_isin(p["p_type"], list(PROMO_TYPES))
          & _isin(p["p_size"], list(sizes))]
    ps = dfs["partsupp"].merge(p, left_on="ps_partkey",
                               right_on="p_partkey", env=env)
    s = dfs["supplier"]
    bad = s[s["s_comment"] == "Customer Complaints"]
    ps = ps.merge(bad[["s_suppkey"]], how="anti", left_on="ps_suppkey",
                  right_on="s_suppkey", env=env)
    g = (ps.groupby(["p_brand", "p_type", "p_size"], env=env)
         .agg([("ps_suppkey", "nunique")]))
    g = g.rename({"ps_suppkey_nunique": "supplier_cnt"})
    return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                         ascending=[False, True, True, True], env=env)


# ---------------------------------------------------------------------------
# Q21 — suppliers who kept orders waiting (SEMI + SEMI-on-condition)
# ---------------------------------------------------------------------------

def q21(dfs: dict, env=None, nation: str = "SAUDI ARABIA",
        limit: int = 100):
    """SELECT s_name, count(*) AS numwait FROM supplier, lineitem l1,
    orders, nation WHERE s_suppkey = l1.l_suppkey AND o_orderkey =
    l1.l_orderkey AND o_orderstatus = 'F' AND l1.l_receiptdate >
    l1.l_commitdate AND EXISTS (l2: same order, other supplier) AND NOT
    EXISTS (l3: same order, other supplier, late) AND s_nationkey =
    n_nationkey AND n_name = :nation GROUP BY s_name ORDER BY numwait
    DESC, s_name LIMIT 100.

    The correlated EXISTS pair decomposes into per-order supplier
    statistics + SEMI joins: an order qualifies for l1's supplier iff it
    has >= 2 distinct suppliers overall and EXACTLY ONE distinct late
    supplier (l1's own)."""
    l = dfs["lineitem"]
    late = l[l["l_receiptdate"] > l["l_commitdate"]]
    o = dfs["orders"]
    of = o[o["o_orderstatus"] == "F"][["o_orderkey"]]
    # per-order distinct-supplier counts (all lines / late lines)
    nsupp = (l.groupby(["l_orderkey"], env=env)
             .agg([("l_suppkey", "nunique")]))
    multi = nsupp[nsupp["l_suppkey_nunique"] >= 2][["l_orderkey"]]
    nlate = (late.groupby(["l_orderkey"], env=env)
             .agg([("l_suppkey", "nunique")]))
    onelate = nlate[nlate["l_suppkey_nunique"] == 1][["l_orderkey"]]
    l1 = late.merge(of, left_on="l_orderkey", right_on="o_orderkey",
                    env=env)
    l1 = l1.merge(multi, how="semi", on="l_orderkey", env=env)
    l1 = l1.merge(onelate, how="semi", on="l_orderkey", env=env)
    s = dfs["supplier"].merge(dfs["nation"], left_on="s_nationkey",
                              right_on="n_nationkey", env=env)
    s = s[s["n_name"] == nation][["s_suppkey", "s_name"]]
    j = l1.merge(s, left_on="l_suppkey", right_on="s_suppkey", env=env)
    g = (j.groupby(["s_name"], env=env).agg([("l_orderkey", "count")])
         .rename({"l_orderkey_count": "numwait"}))
    return g.sort_values(["numwait", "s_name"],
                         ascending=[False, True], env=env).head(limit)


# ---------------------------------------------------------------------------
# Q9 — product type profit (the suite's WIDEST join working set)
# ---------------------------------------------------------------------------

def q9(dfs: dict, env=None, name_part: str = "misty"):
    """SELECT nation, o_year, sum(amount) AS sum_profit FROM (SELECT
    n_name AS nation, extract(year FROM o_orderdate) AS o_year,
    l_extendedprice*(1-l_discount) - ps_supplycost*l_quantity AS amount
    FROM part, supplier, lineitem, partsupp, orders, nation WHERE
    s_suppkey = l_suppkey AND ps_suppkey = l_suppkey AND ps_partkey =
    l_partkey AND p_partkey = l_partkey AND o_orderkey = l_orderkey AND
    s_nationkey = n_nationkey AND p_name LIKE '%:part%') GROUP BY
    nation, o_year ORDER BY nation, o_year DESC.

    Six tables, five joins — including the two-key
    (l_suppkey, l_partkey) ⋈ (ps_suppkey, ps_partkey) edge — over the
    largest fact table: the suite's widest join working set and the
    natural out-of-core exerciser (the disk tier's TPC-H acceptance
    query, docs/robustness.md "Disk tier & scan pushdown").  LIKE rides
    the closed p_name vocabulary as exact-value equality and
    extract(year) rides the generator's derived ``o_orderyear`` int
    column (documented simplifications; the reference's pandas
    oracle uses real
    ``str.contains`` / ``dt.year``)."""
    p = dfs["part"]
    names = [v for v in PNAMES.tolist() if name_part in v]
    p = p[_isin(p["p_name"], names)][["p_partkey"]]
    j = dfs["lineitem"].merge(p, left_on="l_partkey", right_on="p_partkey",
                              env=env)
    ps = dfs["partsupp"][["ps_partkey", "ps_suppkey", "ps_supplycost"]]
    j = j.merge(ps, left_on=["l_partkey", "l_suppkey"],
                right_on=["ps_partkey", "ps_suppkey"], env=env)
    j = j.merge(dfs["supplier"][["s_suppkey", "s_nationkey"]],
                left_on="l_suppkey", right_on="s_suppkey", env=env)
    j = j.merge(dfs["orders"][["o_orderkey", "o_orderyear"]],
                left_on="l_orderkey", right_on="o_orderkey", env=env)
    j = j.merge(dfs["nation"][["n_nationkey", "n_name"]],
                left_on="s_nationkey", right_on="n_nationkey", env=env)
    j["amount"] = (j["l_extendedprice"] * (1.0 - j["l_discount"])
                   - j["ps_supplycost"] * j["l_quantity"].astype("float64"))
    g = (j.groupby(["n_name", "o_orderyear"], env=env)[["amount"]].sum()
         .rename({"amount": "sum_profit"}))
    out = g.sort_values(["n_name", "o_orderyear"],
                        ascending=[True, False], env=env)
    return out[["n_name", "o_orderyear", "sum_profit"]]


# ---------------------------------------------------------------------------
# Q7 — volume shipping (nation-key joins: every key is a heavy hitter)
# ---------------------------------------------------------------------------

def q7(dfs: dict, env=None, nation1: str = "FRANCE",
       nation2: str = "GERMANY"):
    """SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
    FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
    extract(year FROM l_shipdate) AS l_year, l_extendedprice *
    (1 - l_discount) AS volume FROM supplier, lineitem, orders, customer,
    nation n1, nation n2 WHERE s_suppkey = l_suppkey AND o_orderkey =
    l_orderkey AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
    AND c_nationkey = n2.n_nationkey AND ((n1.n_name = :n1 AND n2.n_name
    = :n2) OR (n1.n_name = :n2 AND n2.n_name = :n1)) AND l_shipdate
    BETWEEN date '1995-01-01' AND date '1996-12-31') shipping GROUP BY
    supp_nation, cust_nation, l_year ORDER BY supp_nation, cust_nation,
    l_year.

    Round 14, the adaptive skew-split route's TPC-H exerciser
    (docs/skew.md): the supplier→nation and customer→nation joins run on
    a 25-value key — EVERY key is a heavy hitter under plain hash
    partitioning, the distribution shape the split + duplicate-broadcast
    route exists for.  The symmetric nation-pair disjunction collapses
    to ``s_nationkey != c_nationkey`` once both ends are restricted to
    the two nations; extract(year) rides the generator's derived
    ``l_shipyear`` int column (documented simplification; the reference's
    pandas oracle uses real ``dt.year``)."""
    n = dfs["nation"][["n_nationkey", "n_name"]]
    n = n[_isin(n["n_name"], [nation1, nation2])]
    s = dfs["supplier"][["s_suppkey", "s_nationkey"]].merge(
        n, left_on="s_nationkey", right_on="n_nationkey", env=env)
    s = s.rename({"n_name": "supp_nation"})[
        ["s_suppkey", "s_nationkey", "supp_nation"]]
    c = dfs["customer"][["c_custkey", "c_nationkey"]].merge(
        n, left_on="c_nationkey", right_on="n_nationkey", env=env)
    c = c.rename({"n_name": "cust_nation"})[
        ["c_custkey", "c_nationkey", "cust_nation"]]
    l = dfs["lineitem"]
    l = l[(l["l_shipdate"] >= _ts("1995-01-01"))
          & (l["l_shipdate"] <= _ts("1996-12-31"))]
    l["volume"] = l["l_extendedprice"] * (1.0 - l["l_discount"])
    l = l[["l_orderkey", "l_suppkey", "l_shipyear", "volume"]]
    j = l.merge(s, left_on="l_suppkey", right_on="s_suppkey", env=env)
    j = j.merge(dfs["orders"][["o_orderkey", "o_custkey"]],
                left_on="l_orderkey", right_on="o_orderkey", env=env)
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey", env=env)
    j = j[j["s_nationkey"] != j["c_nationkey"]]
    g = (j.groupby(["supp_nation", "cust_nation", "l_shipyear"], env=env)
         [["volume"]].sum().rename({"volume": "revenue"}))
    out = g.sort_values(["supp_nation", "cust_nation", "l_shipyear"],
                        env=env)
    return out[["supp_nation", "cust_nation", "l_shipyear", "revenue"]]


# ---------------------------------------------------------------------------
# Q8 — national market share (the suite's widest join: 7 tables + region)
# ---------------------------------------------------------------------------

def q8(dfs: dict, env=None, nation: str = "BRAZIL",
       region: str = "AMERICA", ptype: str = "STANDARD PLATED"):
    """SELECT o_year, sum(case when nation = :nation then volume else 0
    end) / sum(volume) AS mkt_share FROM (SELECT extract(year FROM
    o_orderdate) AS o_year, l_extendedprice * (1 - l_discount) AS
    volume, n2.n_name AS nation FROM part, supplier, lineitem, orders,
    customer, nation n1, nation n2, region WHERE p_partkey = l_partkey
    AND s_suppkey = l_suppkey AND l_orderkey = o_orderkey AND o_custkey
    = c_custkey AND c_nationkey = n1.n_nationkey AND n1.n_regionkey =
    r_regionkey AND r_name = :region AND s_nationkey = n2.n_nationkey
    AND o_orderdate BETWEEN date '1995-01-01' AND date '1996-12-31' AND
    p_type = :ptype) all_nations GROUP BY o_year ORDER BY o_year.

    Round 15, the multi-slice topology tier's TPC-H exerciser
    (docs/topology.md): seven tables (part, supplier, lineitem, orders,
    customer, nation ×2, region) chained through SIX shuffle-backed
    joins — the widest cross-slice working set in the suite, every hop
    of which must stay bit-equal whichever route (flat vs two-hop)
    carries its exchanges.  ``extract(year)`` rides the generator's
    derived ``o_orderyear`` int column and ``p_type = :ptype`` the
    closed vocabulary (the same documented simplifications as Q9/Q7);
    the conditional numerator is the Q14 flag-times-value pattern."""
    p = dfs["part"][["p_partkey", "p_type"]]
    p = p[p["p_type"] == ptype]
    o = dfs["orders"][["o_orderkey", "o_custkey", "o_orderdate",
                       "o_orderyear"]]
    o = o[(o["o_orderdate"] >= _ts("1995-01-01"))
          & (o["o_orderdate"] <= _ts("1996-12-31"))]
    reg = dfs["region"]
    reg = reg[reg["r_name"] == region]
    n1 = dfs["nation"][["n_nationkey", "n_regionkey"]].merge(
        reg, left_on="n_regionkey", right_on="r_regionkey", env=env)
    c = dfs["customer"][["c_custkey", "c_nationkey"]].merge(
        n1, left_on="c_nationkey", right_on="n_nationkey", env=env)
    n2 = dfs["nation"][["n_nationkey", "n_name"]]
    s = dfs["supplier"][["s_suppkey", "s_nationkey"]].merge(
        n2, left_on="s_nationkey", right_on="n_nationkey", env=env)
    l = dfs["lineitem"][["l_orderkey", "l_partkey", "l_suppkey",
                         "l_extendedprice", "l_discount"]]
    j = l.merge(p, left_on="l_partkey", right_on="p_partkey", env=env)
    j = j.merge(o, left_on="l_orderkey", right_on="o_orderkey", env=env)
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey", env=env)
    j = j.merge(s, left_on="l_suppkey", right_on="s_suppkey", env=env)
    j["volume"] = j["l_extendedprice"] * (1.0 - j["l_discount"])
    is_nation = j["n_name"] == nation
    j["nation_volume"] = is_nation.astype("float64") * j["volume"]
    g = (j.groupby(["o_orderyear"], env=env)
         [["volume", "nation_volume"]].sum())
    g["mkt_share"] = g["nation_volume"] / g["volume"]
    out = g.sort_values("o_orderyear", env=env)
    return out[["o_orderyear", "mkt_share"]]


# ---------------------------------------------------------------------------
# Q22 — global sales opportunity (ANTI join vs orders)
# ---------------------------------------------------------------------------

def q22(dfs: dict, env=None, codes=(13, 31, 23, 29, 30, 18, 17)):
    """SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
    FROM customer WHERE cntrycode IN :codes AND c_acctbal > (SELECT
    avg(c_acctbal) FROM customer WHERE c_acctbal > 0 AND cntrycode IN
    :codes) AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey =
    c_custkey) GROUP BY cntrycode ORDER BY cntrycode.  cntrycode =
    substring(c_phone,1,2) rides the generator's c_cntrycode int column
    (no device-side substring); the NOT EXISTS is an ANTI join."""
    c = dfs["customer"]
    c = c[_isin(c["c_cntrycode"], list(codes))]
    pos = c[c["c_acctbal"] > 0.0]
    avg_bal = float(pos["c_acctbal"].mean())
    c = c[c["c_acctbal"] > avg_bal]
    c = c.merge(dfs["orders"][["o_custkey"]], how="anti",
                left_on="c_custkey", right_on="o_custkey", env=env)
    g = (c.groupby(["c_cntrycode"], env=env)
         .agg([("c_custkey", "count"), ("c_acctbal", "sum")])
         .rename({"c_custkey_count": "numcust",
                  "c_acctbal_sum": "totacctbal"}))
    return g.sort_values("c_cntrycode", env=env)


# ---------------------------------------------------------------------------
# Q11 — important stock identification (scalar-subquery HAVING)
# ---------------------------------------------------------------------------

def q11(dfs: dict, env=None, nation: str = "GERMANY",
        fraction: float = 0.0001):
    """SELECT ps_partkey, sum(ps_supplycost*ps_availqty) AS value FROM
    partsupp, supplier, nation WHERE ps_suppkey = s_suppkey AND
    s_nationkey = n_nationkey AND n_name = :nation GROUP BY ps_partkey
    HAVING value > :fraction * (SELECT sum(...) same predicate) ORDER BY
    value DESC.  The scalar subquery is the filtered aggregate's own
    total — computed once, threaded through as a host scalar."""
    n = dfs["nation"]
    n = n[n["n_name"] == nation]
    s = dfs["supplier"].merge(n, left_on="s_nationkey",
                              right_on="n_nationkey", env=env)
    ps = dfs["partsupp"].merge(s[["s_suppkey"]], left_on="ps_suppkey",
                               right_on="s_suppkey", env=env)
    ps["value"] = ps["ps_supplycost"] * ps["ps_availqty"].astype("float64")
    g = ps.groupby(["ps_partkey"], env=env)[["value"]].sum()
    total = float(g["value"].sum())
    out = g[g["value"] > fraction * total]
    return out.sort_values(["value", "ps_partkey"],
                           ascending=[False, True],
                           env=env)[["ps_partkey", "value"]]


# ---------------------------------------------------------------------------
# Q15 — top supplier (aggregate view + scalar max equi-select)
# ---------------------------------------------------------------------------

def q15(dfs: dict, env=None, date_lo: str = "1996-01-01",
        date_hi: str = "1996-04-01"):
    """WITH revenue AS (SELECT l_suppkey AS supplier_no,
    sum(l_extendedprice*(1-l_discount)) AS total_revenue FROM lineitem
    WHERE l_shipdate >= :lo AND l_shipdate < :hi GROUP BY l_suppkey)
    SELECT s_suppkey, s_name, total_revenue FROM supplier, revenue WHERE
    s_suppkey = supplier_no AND total_revenue = (SELECT max(...) FROM
    revenue) ORDER BY s_suppkey.  The equi-select compares the view's
    own values against its own max — exact by construction."""
    l = dfs["lineitem"]
    l = l[(l["l_shipdate"] >= _ts(date_lo))
          & (l["l_shipdate"] < _ts(date_hi))]
    l["total_revenue"] = l["l_extendedprice"] * (1.0 - l["l_discount"])
    rev = l.groupby(["l_suppkey"], env=env)[["total_revenue"]].sum()
    top = float(rev["total_revenue"].max())
    best = rev[rev["total_revenue"] >= top]
    j = dfs["supplier"].merge(best, left_on="s_suppkey",
                              right_on="l_suppkey", env=env)
    return j.sort_values("s_suppkey", env=env)[
        ["s_suppkey", "s_name", "total_revenue"]]


# ---------------------------------------------------------------------------
# Q17 — small-quantity-order revenue (correlated avg subquery)
# ---------------------------------------------------------------------------

def q17(dfs: dict, env=None, brand: str = "Brand#23",
        container: str = "MED BOX") -> float:
    """SELECT sum(l_extendedprice) / 7.0 AS avg_yearly FROM lineitem,
    part WHERE p_partkey = l_partkey AND p_brand = :brand AND
    p_container = :container AND l_quantity < (SELECT 0.2*avg(l_quantity)
    FROM lineitem WHERE l_partkey = p_partkey).  The correlated avg
    decomposes into a per-part groupby mean joined back onto the lines
    (reference pattern: DistributedHashGroupBy then DistributedJoin)."""
    p = dfs["part"]
    p = p[(p["p_brand"] == brand)
          & (p["p_container"] == container)][["p_partkey"]]
    j = dfs["lineitem"].merge(p, left_on="l_partkey", right_on="p_partkey",
                              env=env)
    avg = j.groupby(["l_partkey"], env=env).agg([("l_quantity", "mean")])
    j2 = j.merge(avg, on="l_partkey", env=env)
    f = j2[j2["l_quantity"].astype("float64")
           < j2["l_quantity_mean"] * 0.2]
    return float(f["l_extendedprice"].sum()) / 7.0


# ---------------------------------------------------------------------------
# Q20 — potential part promotion (nested IN-subqueries over partsupp)
# ---------------------------------------------------------------------------

def q20(dfs: dict, env=None, name_prefix: str = "forest",
        nation: str = "CANADA", date_lo: str = "1994-01-01",
        date_hi: str = "1995-01-01"):
    """SELECT s_name FROM supplier, nation WHERE s_suppkey IN (SELECT
    ps_suppkey FROM partsupp WHERE ps_partkey IN (SELECT p_partkey FROM
    part WHERE p_name LIKE :prefix%) AND ps_availqty > (SELECT
    0.5*sum(l_quantity) FROM lineitem WHERE l_partkey = ps_partkey AND
    l_suppkey = ps_suppkey AND l_shipdate IN [:lo, :hi))) AND
    s_nationkey = n_nationkey AND n_name = :nation ORDER BY s_name.

    The streaming-friendly partsupp semantics: the correlated half-sum
    subquery decomposes into a two-key groupby over the date-filtered
    lineitem joined back onto partsupp (an empty inner sum is NULL in
    SQL — comparison false — which the inner join reproduces), the
    nested INs become a filter + two SEMI joins, and LIKE 'forest%'
    rides the closed p_name vocabulary as exact-value equality
    (documented simplification, same as Q22's phone prefix; the reference's
    pandas oracle uses a real str.startswith)."""
    p = dfs["part"]
    forest = [v for v in PNAMES.tolist() if v.startswith(name_prefix)]
    p = p[_isin(p["p_name"], forest)][["p_partkey"]]
    l = dfs["lineitem"]
    l = l[(l["l_shipdate"] >= _ts(date_lo))
          & (l["l_shipdate"] < _ts(date_hi))]
    half = (l.groupby(["l_partkey", "l_suppkey"], env=env)
            .agg([("l_quantity", "sum")]))
    ps = dfs["partsupp"].merge(p, how="semi", left_on="ps_partkey",
                               right_on="p_partkey", env=env)
    j = ps.merge(half, left_on=["ps_partkey", "ps_suppkey"],
                 right_on=["l_partkey", "l_suppkey"], env=env)
    f = j[j["ps_availqty"].astype("float64")
          > 0.5 * j["l_quantity_sum"].astype("float64")]
    s = dfs["supplier"].merge(f[["ps_suppkey"]], how="semi",
                              left_on="s_suppkey", right_on="ps_suppkey",
                              env=env)
    n = dfs["nation"]
    n = n[n["n_name"] == nation]
    out = s.merge(n, left_on="s_nationkey", right_on="n_nationkey",
                  env=env)
    return out.sort_values("s_name", env=env)[["s_name"]]
