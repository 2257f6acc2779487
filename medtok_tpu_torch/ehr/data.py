"""EHR data model: Event / Visit / Patient (own copy of
``medtok_tpu/ehr/data.py``).

An Event is one coded fact (code, table, vocabulary, timestamp); a Visit
groups events by table with encounter / discharge times and a discharge
status; a Patient is the time-ordered list of visits plus demographics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any


@dataclass
class Event:
    code: str
    table: str
    vocabulary: str
    visit_id: str
    patient_id: str
    timestamp: datetime | None = None
    attr_dict: dict[str, Any] = field(default_factory=dict)


@dataclass
class Visit:
    visit_id: str
    patient_id: str
    encounter_time: datetime | None = None
    discharge_time: datetime | None = None
    discharge_status: Any = None
    attr_dict: dict[str, Any] = field(default_factory=dict)
    event_list_dict: dict[str, list[Event]] = field(default_factory=dict)

    def add_event(self, event: Event) -> None:
        self.event_list_dict.setdefault(event.table, []).append(event)

    def get_code_list(self, table: str, remove_duplicate: bool = True) -> list[str]:
        codes = [e.code for e in self.event_list_dict.get(table, [])]
        if remove_duplicate:
            codes = list(dict.fromkeys(codes))  # order-preserving dedup
        return codes

    @property
    def available_tables(self) -> list[str]:
        return list(self.event_list_dict)

    @property
    def num_events(self) -> int:
        return sum(len(v) for v in self.event_list_dict.values())


@dataclass
class Patient:
    patient_id: str
    birth_datetime: datetime | None = None
    death_datetime: datetime | None = None
    gender: Any = None
    ethnicity: Any = None
    attr_dict: dict[str, Any] = field(default_factory=dict)
    visits: dict[str, Visit] = field(default_factory=dict)
    index_to_visit_id: list[str] = field(default_factory=list)

    def add_visit(self, visit: Visit) -> None:
        self.visits[visit.visit_id] = visit
        self.index_to_visit_id.append(visit.visit_id)

    def add_event(self, event: Event) -> None:
        if event.visit_id in self.visits:
            self.visits[event.visit_id].add_event(event)

    def get_visit_by_id(self, visit_id: str) -> Visit:
        return self.visits[visit_id]

    def __len__(self) -> int:
        return len(self.visits)

    def __getitem__(self, index: int) -> Visit:
        return self.visits[self.index_to_visit_id[index]]

    def __iter__(self):
        for vid in self.index_to_visit_id:
            yield self.visits[vid]
